"""A NumPy mirror of the decode kernel's window and history ring, held against the plain version, the oracle and the spec.

``csrc/decode.cu`` decodes one block per warp, ``WARPS`` warps to a CTA.
Each warp keeps, in its own slice of shared memory:

- a payload window of two ``HALF``-byte halves, payload byte ``q`` in slot
  ``q & (2 * HALF - 1)``, zero at and past ``comp_len``. The halves are
  filled by asynchronous copies, one group a half, oldest first. A read of
  ``[pos, end)`` (the header's two aligned words from ``p & ~3``,
  ``HEADER_MARGIN`` bytes from ``p``; a literal step's ``STEP`` bytes) first
  slides the window when ``pos`` has left the first half (the passed half's
  slots take the half after the second; both passed: restage at ``pos``),
  then waits for the first half alone or for both when ``end`` is past the
  bytes that have arrived. The header after each element is read as soon
  as the element's header is decoded, past ``comp_len`` too (the window's
  zeros, unused);
- a history ring of ``RING`` output bytes, position ``x`` in slot
  ``x & (RING - 1)``. Before an element (or a literal step) writes
  ``[o, e)`` it flushes a ``CHUNK``-byte chunk to the row when
  ``e > flushed + RING`` (one is enough). A copy's source byte ``s`` comes
  from the ring when ``s >= e - RING`` and from the row otherwise, byte by
  byte; a copy with no overlap whose sources are all in the ring takes the
  kernel's fast path, the others its slow one, and one that also needs no
  refill, no flush and sets no error bit its short path, as does a literal
  of at most 32 bytes whose length is in its tag. At the end
  the unflushed bytes below ``min(o, out_len)``, then zeros to
  ``block_size``, go to the row. A copy with a bad offset writes zeros.

The mirror below follows those steps and checks every read: a window byte
must have arrived and be the byte asked for, a ring byte must still be in
its slot, a row byte must have been flushed, a flushed chunk must be fully
written, and a ring write may only take a slot whose byte is in the row. It
must equal a flat serial walk (the same walk over a whole output row, the
design the kernel had before: exact error bits and every byte of every row),
``hopper_decode.decode_blocks_torch`` and the reference's
``lane_model.decode_lanes`` (verdicts on every block, bytes on valid
blocks), and ``format/oracle.py`` (bytes on valid blocks, verdicts on
every block). Exact: integers. The plain version steps once per payload
byte (about 0.5 ms a step on a CPU), so it sees the blocks whose payloads
are short, and the spec, whose routing is slow at large blocks, the short
blocks up to 4 KB; the flat walk and the oracle see every block.
"""

from __future__ import annotations

import collections
import functools
import pathlib
import random
import re

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model
from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.ops import hopper_decode
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

from decode_window_mirror import BAD, CHUNK, HALF, HEADER_MARGIN, LEN, OVERRUN, RING, STEP, WARPS, decode_window_model

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

SHARED_PER_SM = 233472  # bytes of shared memory on an H100 SM
SHARED_RESERVED_PER_CTA = 1024
DECODE_CU = pathlib.Path(hopper_decode.__file__).resolve().parent.parent / "csrc" / "decode.cu"


def flat_decode(payload: bytes, olen: int, bs: int, counts=None) -> tuple[bytes, int]:
    """The serial walk over a whole zeroed output row (the kernel's design
    before the ring): its error bits and row. ``counts`` (a Counter), where
    given, adds the elements walked, the bytes valid copies copied, and
    those whose source lies more than the kernel's ring behind the copy's
    end."""
    counts = collections.Counter() if counts is None else counts
    clen = len(payload)
    out = bytearray(bs)
    err = LEN if olen < 0 or olen > bs else 0
    wlim = min(max(olen, 0), bs)
    p = o = 0
    while p < clen:
        counts["elements"] += 1
        tag = payload[p]
        p += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                n = length - 60
                if p + n > clen:
                    err |= OVERRUN
                    break
                acc = int.from_bytes(payload[p : p + min(n, 3)], "little")
                if n > 3 and payload[p + 3]:
                    err |= OVERRUN
                p += n
                length = acc + 1
            take = min(length, clen - p)
            if take > 0 and o + take > olen:
                err |= LEN
            wend = min(o + take, wlim)
            if wend > o:
                out[o:wend] = payload[p : p + wend - o]
            o += take
            p += take
            if take < length:
                err |= OVERRUN
                break
        else:
            n = 4 if kind == 3 else kind
            length = ((tag >> 2) & 7) + 4 if kind == 1 else (tag >> 2) + 1
            if p + n > clen:
                err |= OVERRUN
                break
            if kind == 1:
                off = ((tag >> 5) << 8) | payload[p]
            else:
                off = int.from_bytes(payload[p : p + min(n, 3)], "little")
            high = kind == 3 and payload[p + 3] != 0
            p += n
            bad = off == 0 or off > o or off > bs or high
            if bad:
                err |= BAD
            if o + length > olen:
                err |= LEN
            if not bad and o < wlim:
                e = min(o + length, wlim)
                for i in range(o, e):
                    out[i] = out[i - off]
                counts["copied"] += e - o
                counts["from_row"] += min(max(e - RING + off - o, 0), e - o)  # sources i - off below e - RING
            o += length
    if o != olen:
        err |= LEN
    return bytes(out), err


# --- inputs -------------------------------------------------------------

BLOCK_SIZES = [256, 4096, 32768, 65536]
# (ring, chunk, half): two small ones, so that every edge is met many times
# in a block, and the kernel's own.
GEOMETRIES = [(256, 64, 32), (1024, 256, 64), (RING, CHUNK, HALF)]
PLAIN_PAYLOAD_LIMIT = 6000  # payload bytes the plain version and the spec step through here


def _seed_literal(rng: random.Random, n: int) -> bytes:
    return streams._literal(rng.randbytes(n))


def _pack(elements, bs: int, rng: random.Random) -> list[tuple[bytes, int]]:
    """Copies (offset, length), in order, packed into blocks of at most bs
    output bytes, each opened by a 64-byte literal (a copy that does not
    fit its block's history is dropped)."""
    blocks, payload, o = [], b"", 0
    for off, length in elements:
        if not payload:
            payload, o = _seed_literal(rng, min(64, bs)), min(64, bs)
        if o + length > bs:
            blocks.append((payload, o))
            payload, o = _seed_literal(rng, min(64, bs)), min(64, bs)
        if off <= o and o + length <= bs:
            payload += streams._copy(off, length, 1 if length < 12 and off < 2048 else (2 if off < 65536 else 4))
            o += length
    if payload:
        blocks.append((payload, o))
    return blocks


def _grow(o_to: int, bs: int) -> list[tuple[int, int]]:
    """Copies at offset 64, 64 bytes each, that take a block's output from 64 to o_to."""
    return [(64, 64)] * max(0, (min(o_to, bs) - 64) // 64)


@functools.lru_cache(maxsize=None)
def crafted_blocks(bs: int) -> list[tuple[bytes, int]]:
    """Short payloads that reach the design's edges: runs at offsets 1-31 over
    lengths up to 64, copies across each geometry's ring reach and at the
    largest offsets, a literal longer than the ring, COPY_4 offsets."""
    rng = random.Random(bs)
    runs = [(d, n) for d in range(1, 32) for n in (4, 11, 31, 32, 33, 63, 64)]
    blocks = _pack(runs, bs, rng)
    for ring in sorted({g[0] for g in GEOMETRIES}):
        if ring + 200 > bs:
            continue
        # Offsets around the ring's reach: sources all in the ring, across its
        # boundary (ring - length < d < ring), and all in the row.
        reach = [(d, n) for n in (20, 64) for d in range(ring - n - 1, ring + 3)]
        blocks += _pack(_grow(ring + 128, bs) + reach + [(ring + 64, 64)] * 4, bs, rng)
    if bs > 32768:  # offsets from 32768 up, and the largest a block allows
        blocks += _pack(_grow(bs - 200, bs) + [(bs - 300, 64), (40000, 37), (bs - 201, 5)], bs, rng)
    # A literal longer than every ring that fits, then copies back into it.
    n = min(bs - 100, 20000)
    lit = rng.randbytes(n)
    payload = streams._literal(lit) + streams._copy(n, 30, 2) + streams._copy(min(n, 9000), 40, 4)
    blocks.append((payload, n + 70))
    return blocks


@functools.lru_cache(maxsize=None)
def cases(bs: int) -> tuple[list[tuple[bytes, int]], int]:
    """(blocks, number of valid blocks first): the native and oracle codecs'
    streams of text (a far-repeat block at 64 KB), the hand-built blocks, the
    crafted ones, then block mutants."""
    text = streams.text_payload(2 * bs if bs <= 4096 else bs + bs // 3, bs)
    if bs == 65536:
        text = streams.far_repeat_block(bs, 2) + text
    valid = []
    for codec in (native.compress, oracle.compress):
        stream = codec(text if codec is native.compress else text[: bs + 999], bs)
        info = pipeline.scan_frames(stream)
        valid += [(stream[o : o + s], int(m)) for o, s, m in
                  zip(info["payload_off"], info["payload_size"], info["out_size"])]
    valid += streams.hand_blocks(bs) + crafted_blocks(bs) + [(b"", 0)]
    base = [blk for blk in valid if blk[0] and (bs <= 4096 or len(blk[0]) <= PLAIN_PAYLOAD_LIMIT)]
    mutants = streams.block_mutants(base, random.Random(bs + 7), 40, bs)
    # Literals the walk passes without writing (past out_len): the cursor
    # jumps past both halves of the window, which is restaged where it lands.
    rng = random.Random(bs + 8)
    n = min(pipeline.padded_capacity(bs) // 3, 6000)
    skip = streams._literal(rng.randbytes(n)) + streams._literal(rng.randbytes(n)) + streams._copy(1, 4, 1)
    mutants += [(skip, min(bs, n // 2)), (skip, min(bs, n + 4))]
    return valid + mutants, len(valid)


def slots(blocks, bs: int):
    cap = pipeline.padded_capacity(bs)
    comp = np.zeros((len(blocks), cap), np.uint8)
    clen = np.zeros(len(blocks), np.int32)
    olen = np.zeros(len(blocks), np.int32)
    for i, (payload, n) in enumerate(blocks):
        comp[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        clen[i], olen[i] = len(payload), n
    return comp, clen, olen


@functools.lru_cache(maxsize=None)
def flat(bs: int):
    blocks, _ = cases(bs)
    rows, errs = zip(*(flat_decode(p, n, bs) for p, n in blocks))
    return np.frombuffer(b"".join(rows), np.uint8).reshape(len(blocks), bs), np.array(errs, np.int32)


@functools.lru_cache(maxsize=None)
def plain(bs: int):
    """decode_blocks_torch on the short-payload blocks, and up to 4 KB
    blocks lane_model.decode_lanes (its routing takes about 15 s a batch at
    64 KB here): (indices, (out, err), (out, err) or None)."""
    blocks, _ = cases(bs)
    idx = [i for i, (p, _) in enumerate(blocks) if len(p) <= PLAIN_PAYLOAD_LIMIT]
    comp, clen, olen = slots([blocks[i] for i in idx], bs)
    out_t, err_t = hopper_decode.decode_blocks_torch(*map(torch.from_numpy, (comp, clen, olen)), bs)
    spec = None
    if bs <= 4096:
        out_l, err_l = lane_model.decode_lanes(comp, clen, olen, bs)
        spec = np.asarray(out_l), np.asarray(err_l)
    return idx, (out_t.numpy(), err_t.numpy()), spec


STATS: dict = {}


def test_constants_are_the_kernels():
    src = DECODE_CU.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert {k: consts[k] for k in ("kWarps", "kRing", "kChunk", "kHalf", "kHeaderMargin", "kStep")} == {
        "kWarps": WARPS, "kRing": RING, "kChunk": CHUNK, "kHalf": HALF, "kHeaderMargin": HEADER_MARGIN,
        "kStep": STEP,
    }
    # The footprint depends on neither block_size nor cap, and at least 8
    # walks (1024 blocks over 132 SMs) fit on an SM.
    per_cta = WARPS * (RING + 2 * HALF) + SHARED_RESERVED_PER_CTA
    assert WARPS * (SHARED_PER_SM // per_cta) >= 8
    assert "block_size" not in src.split("constexpr int kSharedBytes")[1].split(";")[0]


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("ring, chunk, half", GEOMETRIES, ids=[f"r{r}-w{2 * h}" for r, _, h in GEOMETRIES])
def test_mirror_matches_flat_walk_and_plain_decode(ring, chunk, half, bs):
    blocks, n_valid = cases(bs)
    comp, clen, olen = slots(blocks, bs)
    stats = collections.Counter()
    out, err = decode_window_model(comp, clen, olen, bs, ring, chunk, half, stats=stats)
    STATS[(ring, half, bs)] = stats
    want_out, want_err = flat(bs)
    np.testing.assert_array_equal(err, want_err)  # exact bits
    np.testing.assert_array_equal(out, want_out)  # every byte, malformed blocks too
    assert not err[:n_valid].any()
    assert (out[np.arange(bs)[None, :] >= olen[:, None]] == 0).all()  # the zero tail
    idx, (out_t, err_t), _ = plain(bs)
    np.testing.assert_array_equal(err[idx] != 0, err_t != 0)
    for k, i in enumerate(idx):
        if err_t[k] == 0:
            assert out[i, : olen[i]].tobytes() == out_t[k, : olen[i]].tobytes(), f"block {i}"


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_flat_walk_matches_oracle_and_spec(bs):
    """The references agree: the flat walk, the oracle (bytes on valid
    blocks, verdicts on every block), and the plain version against the
    spec (error bits and valid bytes)."""
    blocks, n_valid = cases(bs)
    out, err = flat(bs)
    for i, (payload, n) in enumerate(blocks):
        if n == 0:  # a stream cannot frame a block of no output
            continue
        try:
            want = oracle.decompress(streams.frame_block(payload, n, bs))
        except Exception:  # noqa: BLE001 - a malformed block: the verdict is all that is compared
            want = None
        assert (want is None) == (err[i] != 0), f"block {i}: oracle {'rejects' if want is None else 'accepts'}"
        if want is not None:
            assert out[i, :n].tobytes() == want
    idx, (out_t, err_t), spec = plain(bs)
    np.testing.assert_array_equal(err[idx] != 0, err_t != 0)
    for k, i in enumerate(idx):
        n = blocks[i][1]
        if err_t[k] == 0:
            assert out_t[k, :n].tobytes() == out[i, :n].tobytes()
    if spec is not None:
        out_l, err_l = spec
        np.testing.assert_array_equal(err_t, err_l)
        for k, i in enumerate(idx):
            if err_l[k] == 0:
                assert out_l[k, : blocks[i][1]].tobytes() == out_t[k, : blocks[i][1]].tobytes()
    assert len(idx) > n_valid // 3


def test_mirror_meets_every_edge():
    """Summed over the small geometries' cases, each edge of the design was met."""
    total = collections.Counter()
    for ring, chunk, half in GEOMETRIES[:2]:
        for bs in BLOCK_SIZES:
            key = (ring, half, bs)
            if key not in STATS:  # run alone: compute it here
                stats = collections.Counter()
                decode_window_model(*slots(cases(bs)[0], bs), bs, ring, chunk, half, stats=stats)
                STATS[key] = stats
            total += STATS[key]
    for edge in ("short_path_copies", "short_path_literals", "fast_copies", "window_slides", "window_restages", "waits_first_half", "waits_both_halves",
                 "headers_across_halves", "header_words_wrap", "stagings_past_comp_len", "flushes",
                 "row_reads", "copies_straddling_the_ring", "overlapping_copies", "offsets_from_32768",
                 "literals_longer_than_ring", "bad_copies_zeroed", "zero_tails", "truncated_headers",
                 "literals_past_payload", "elements_after_an_error", "empty_payloads",
                 "payload_not_16_byte_multiple", "idle_warps"):
        assert total[edge] > 0, edge
    kernel = STATS.get((RING, HALF, 65536))
    if kernel is not None:  # the kernel's own geometry reads the row too
        assert kernel["row_reads"] > 0 and kernel["copies_straddling_the_ring"] > 0


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_mirror_counts_what_the_traced_kernel_counts(bs):
    """At the kernel's geometry the mirror counts what the traced decode
    kernel counts, which tests/test_torch_cuda.py holds the kernel to:
    elements walked, bytes valid copies copied and those read from the row
    past the ring, each equal to the flat walk's count on every case; some
    elements take a short path and some the general one, and only a block
    larger than the ring reads the row."""
    key = (RING, HALF, bs)
    if key not in STATS:  # run alone: compute it here
        stats = collections.Counter()
        decode_window_model(*slots(cases(bs)[0], bs), bs, stats=stats)
        STATS[key] = stats
    stats = STATS[key]
    want = collections.Counter()
    for payload, n in cases(bs)[0]:
        flat_decode(payload, n, bs, counts=want)
    assert (stats["elements"], stats["copied_bytes"], stats["row_reads"]) == (
        want["elements"], want["copied"], want["from_row"])
    general = stats["elements"] - stats["short_path_copies"] - stats["short_path_literals"]
    assert 0 < general < stats["elements"]
    assert (stats["row_reads"] > 0) == (bs > RING)
