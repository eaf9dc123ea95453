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

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

# The kernel's constants (csrc/decode.cu), checked against its source below.
WARPS = 4
RING = 16384
CHUNK = 4096
HALF = 1024
HEADER_MARGIN = 8  # the header's two aligned words from p & ~3
STEP = 32  # payload bytes a literal step moves
POISON = 0xEE
LEN, BAD, OVERRUN = hopper_decode.ERR_LENGTH_MISMATCH, hopper_decode.ERR_BAD_OFFSET, hopper_decode.ERR_ELEMENT_OVERRUN
SHARED_PER_SM = 233472  # bytes of shared memory on an H100 SM
SHARED_RESERVED_PER_CTA = 1024
DECODE_CU = pathlib.Path(hopper_decode.__file__).resolve().parent.parent / "csrc" / "decode.cu"


class _Window:
    """One warp's payload window: halves in flight or arrived, every slot's position."""

    def __init__(self, src: bytes, clen: int, half: int, stats):
        self.src, self.clen, self.half, self.stats = src, clen, half, stats
        self.mask = 2 * half - 1
        self.slots = bytearray(2 * half)
        self.slot_pos = [-1] * (2 * half)
        self.arrived = [False] * (2 * half)
        self.pending = collections.deque()  # half starts in flight, oldest first
        self.base = self.ready = 0
        self.last_pos = 0
        self.stage(0)
        self.stage(half)

    def stage(self, at: int) -> None:
        assert at % self.half == 0 and at >= 0
        lo = at & self.mask
        for j in range(self.half):
            q = at + j
            self.slots[lo + j] = self.src[q] if q < self.clen else 0  # nothing at or past clen is read
            self.slot_pos[lo + j] = q
            self.arrived[lo + j] = False
        if at + self.half > self.clen:
            self.stats["stagings_past_comp_len"] += 1
        self.pending.append(at)

    def wait(self, keep: int) -> None:
        while len(self.pending) > keep:
            at = self.pending.popleft()
            lo = at & self.mask
            for j in range(self.half):
                self.arrived[lo + j] = True

    def ready_for(self, pos: int, end: int) -> bool:
        """Whether [pos, end) can be read with no refill (the kernel's limits)."""
        return not (end > self.ready or pos >= self.base + self.half)

    def need(self, pos: int, end: int) -> None:
        """The kernel's test before a read of [pos, end), then its refill."""
        assert pos >= self.last_pos and end - pos <= self.half
        self.last_pos = pos
        if not (end > self.ready or pos >= self.base + self.half):
            return
        half = self.half
        if pos >= self.base + half:
            if pos >= self.base + 2 * half:
                self.wait(0)
                self.base = pos & ~(half - 1)
                self.ready = self.base
                self.stage(self.base)
                self.stats["window_restages"] += 1
            else:
                self.base += half
                self.stats["window_slides"] += 1
            self.stage(self.base + half)
        if end > self.ready:
            if end <= self.base + half:
                self.wait(1)
                self.ready = self.base + half
                self.stats["waits_first_half"] += 1
            else:
                self.wait(0)
                self.ready = self.base + 2 * half
                self.stats["waits_both_halves"] += 1

    def read(self, pos: int, n: int) -> bytes:
        out = bytearray(n)
        for j in range(n):
            slot = (pos + j) & self.mask
            assert self.arrived[slot], f"payload byte {pos + j} read before it arrived"
            assert self.slot_pos[slot] == pos + j, f"slot {slot} holds {self.slot_pos[slot]}, not {pos + j}"
            out[j] = self.slots[slot]
        return bytes(out)

    def header(self, p: int) -> tuple[int, int]:
        """(tag, the four bytes after it) from the two aligned words at p & ~3."""
        a = p & ~3
        if (a >> 2) & (self.mask >> 2) == self.mask >> 2:
            self.stats["header_words_wrap"] += 1
        if (a & ~(self.half - 1)) != ((a + 7) & ~(self.half - 1)):
            self.stats["headers_across_halves"] += 1
        word = self.read(a, 8)
        h = word[p - a : p - a + 5]
        return h[0], int.from_bytes(h[1:5], "little")


class _Ring:
    """One warp's history ring, its flushes, and the block's output row."""

    def __init__(self, bs: int, ring: int, chunk: int, stats):
        self.bs, self.size, self.chunk, self.stats = bs, ring, chunk, stats
        self.mask = ring - 1
        self.vals = bytearray(ring)
        self.pos = [-1] * ring
        self.row = bytearray([POISON]) * bs
        self.written = bytearray(bs)
        self.flushed = 0

    def make_room(self, e: int) -> None:
        """One chunk at most: a write reaches at most 64 bytes past the last."""
        if e > self.flushed + self.size:
            start = self.flushed
            assert start + self.chunk <= self.bs
            for x in range(start, start + self.chunk):
                assert self.pos[x & self.mask] == x, f"flushing position {x}, not yet written"
                self.row[x] = self.vals[x & self.mask]
                self.written[x] = 1
            self.flushed += self.chunk
            self.stats["flushes"] += 1
        assert e <= self.flushed + self.size

    def write(self, x: int, value: int) -> None:
        slot = x & self.mask
        assert 0 <= x < self.bs
        assert self.pos[slot] < self.flushed, f"position {x} overwrites {self.pos[slot]}, not yet in the row"
        self.vals[slot] = value
        self.pos[slot] = x

    def read(self, s: int, near: int) -> int:
        if s >= near:
            assert self.pos[s & self.mask] == s, f"ring slot of {s} holds {self.pos[s & self.mask]}"
            return self.vals[s & self.mask]
        assert 0 <= s < self.flushed, f"row byte {s} read before its chunk was flushed"
        return self.row[s]

    def finish(self, w: int) -> bytes:
        for x in range(self.flushed, self.bs):
            if x < w:
                assert self.pos[x & self.mask] == x
                self.row[x] = self.vals[x & self.mask]
            else:
                self.row[x] = 0
            self.written[x] = 1
        assert all(self.written), "a byte of the row was never written"
        if w < self.bs:
            self.stats["zero_tails"] += 1
        return bytes(self.row)


def _copy_near(rg: _Ring, o: int, e: int, off: int) -> None:
    """The kernel's copy_near: no overlap, every source in the ring, every load before the stores."""
    assert off >= e - o and o - off >= e - rg.size
    values = [rg.read(o + k - off, e - rg.size) for k in range(e - o)]
    for k, value in enumerate(values):
        rg.write(o + k, value)


def _walk(src: bytes, clen: int, olen: int, bs: int, ring: int, chunk: int, half: int, stats) -> tuple[bytes, int]:
    """One warp's walk of one block, as csrc/decode.cu runs it."""
    win = _Window(src, clen, half, stats)
    rg = _Ring(bs, ring, chunk, stats)
    err = LEN if olen < 0 or olen > bs else 0
    wlim = min(max(olen, 0), bs)
    p = o = 0
    tag = after = 0
    if p < clen:
        win.need(p, p + HEADER_MARGIN)
        tag, after = win.header(p)
    while p < clen:
        if err:
            stats["elements_after_an_error"] += 1
        kind = tag & 3
        if kind == 0:
            short = (tag >> 2) + 1
            if (short <= 32 and p + 1 + short <= clen and o + short <= wlim and win.ready_for(p + 1, p + 1 + STEP)
                    and win.ready_for(p + 1 + short, p + 1 + short + HEADER_MARGIN) and o + short <= rg.flushed + ring):
                # The kernel's short path: one step, no refill, no flush, no error.
                win.need(p + 1, p + 1 + STEP)
                data = win.read(p + 1, STEP)  # every lane reads its byte
                p += 1 + short
                win.need(p, p + HEADER_MARGIN)
                tag, after = win.header(p)
                for lane in range(short):
                    rg.write(o + lane, data[lane])
                o += short
                stats["short_path_literals"] += 1
                continue
            n = (tag >> 2) - 59 if tag >= 240 else 0
            if p + 1 + n > clen:
                err |= OVERRUN
                stats["truncated_headers"] += 1
                break
            length = (tag >> 2) + 1
            if n:
                length = (after & (0xFFFFFF >> (8 * (3 - min(n, 3))))) + 1
                if n == 4 and after >> 24:
                    err |= OVERRUN
            lp = p + 1 + n
            take = min(length, clen - lp)
            if take > 0 and o + take > olen:
                err |= LEN
            wend = min(o + take, wlim)
            if wend - o > ring:
                stats["literals_longer_than_ring"] += 1
            for q in range(o, wend, STEP):
                at = lp + (q - o)
                win.need(at, at + STEP)
                end = min(q + STEP, wend)
                rg.make_room(end)
                data = win.read(at, STEP)  # every lane reads its byte
                for lane in range(end - q):
                    rg.write(q + lane, data[lane])
            o += take
            p = lp + take
            if take < length:
                err |= OVERRUN
                stats["literals_past_payload"] += 1
                break
            win.need(p, p + HEADER_MARGIN)  # past clen it reads the window's zeros
            tag, after = win.header(p)
        else:
            n = 4 if kind == 3 else kind
            length = ((tag >> 2) & 7) + 4 if kind == 1 else (tag >> 2) + 1
            if p + 1 + n > clen:
                err |= OVERRUN
                stats["truncated_headers"] += 1
                break
            off = ((tag >> 5) << 8) | (after & 0xFF) if kind == 1 else after & (0xFFFF if kind == 2 else 0xFFFFFF)
            high = kind == 3 and (after >> 24) != 0
            if (0 < off <= o and o + length <= wlim and length <= off <= ring - length and not high
                    and win.ready_for(p + 1 + n, p + 1 + n + HEADER_MARGIN) and o + length <= rg.flushed + ring):
                # The kernel's short path: no refill, no flush, no error, every source in the ring.
                p += 1 + n
                win.need(p, p + HEADER_MARGIN)
                tag, after = win.header(p)
                _copy_near(rg, o, o + length, off)
                o += length
                stats["short_path_copies"] += 1
                continue
            p += 1 + n
            win.need(p, p + HEADER_MARGIN)  # the next header, read before this copy's bytes
            next_tag, next_after = win.header(p)
            bad = off == 0 or off > o or off > bs or high
            if bad:
                err |= BAD
            if o + length > olen:
                err |= LEN
            if o < wlim:
                e = min(o + length, wlim)
                rg.make_room(e)
                near = e - ring
                values = []
                if not bad and off >= length and off <= ring - (e - o):  # the kernel's fast path
                    stats["fast_copies"] += 1
                    _copy_near(rg, o, e, off)
                elif bad:
                    values = [0] * (e - o)
                    stats["bad_copies_zeroed"] += 1
                else:
                    d = off
                    far = 0
                    for k in range(e - o):
                        lane, upper = k & 31, k >= 32
                        if d < length:  # period position: lane % d, then + 32 % d once
                            r = lane % d
                            if upper:
                                r += 32 % d
                                if r >= d:
                                    r -= d
                            s = o - d + r
                        else:
                            s = o + k - d
                        far += s < near
                        values.append(rg.read(s, near))
                    stats["overlapping_copies"] += d < length
                    stats["row_reads"] += far
                    stats["copies_reading_the_row"] += far > 0
                    stats["copies_straddling_the_ring"] += 0 < far < e - o
                    stats["offsets_from_32768"] += d >= 32768
                for k, value in enumerate(values):  # every load before the stores
                    rg.write(o + k, value)
            o += length
            tag, after = next_tag, next_after
    if o != olen:
        err |= LEN
    win.wait(0)
    return rg.finish(min(o, wlim)), err


def decode_window_model(comp, clen, olen, bs, ring=RING, chunk=CHUNK, half=HALF, stats=None):
    """The kernel's decode on numpy arrays: (out uint8[nb, bs], err int32[nb]).

    ``stats`` (a Counter) collects how often each edge of the design was met.
    """
    assert ring & (ring - 1) == 0 and ring % chunk == 0 and chunk <= ring - 64
    assert half & (half - 1) == 0 and half >= max(STEP, HEADER_MARGIN) and half % 16 == 0
    stats = collections.Counter() if stats is None else stats
    nb, cap = comp.shape
    out = np.empty((nb, bs), np.uint8)
    err = np.empty(nb, np.int32)
    for cta in reversed(range(-(-nb // WARPS))):
        for warp in reversed(range(WARPS)):
            b = cta * WARPS + warp
            if b >= nb:
                stats["idle_warps"] += 1
                continue
            n = min(max(int(clen[b]), 0), cap)
            row, e = _walk(comp[b].tobytes(), n, int(olen[b]), bs, ring, chunk, half, stats)
            out[b] = np.frombuffer(row, np.uint8)
            err[b] = e
            stats["blocks"] += 1
            stats["empty_payloads"] += n == 0
            stats["payload_not_16_byte_multiple"] += n % 16 != 0
    return out, err


def flat_decode(payload: bytes, olen: int, bs: int) -> tuple[bytes, int]:
    """The serial walk over a whole zeroed output row (the kernel's design
    before the ring): its error bits and row."""
    clen = len(payload)
    out = bytearray(bs)
    err = LEN if olen < 0 or olen > bs else 0
    wlim = min(max(olen, 0), bs)
    p = o = 0
    while p < clen:
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
                for i in range(o, min(o + length, wlim)):
                    out[i] = out[i - off]
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
