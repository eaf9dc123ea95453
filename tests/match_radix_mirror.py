"""A NumPy mirror of the match kernel's rung sort and lag sweep (``csrc/match.cu``).

``radix_sort`` follows the kernel's two LSD radix passes in its
shared-memory layout (each warp's column of counts, the digit-major scan,
peer rank plus running offset), and ``kernel_prev_lags`` a rung's lag
sweep: the sorted predecessor, the window's group compare and, where a rung
sorts its 32 KB halves in turn, the second half's key-indexed lookup of the
first half's last word with its key (a table that is never cleared, each
slot held to the word it points at). ``tests/test_torch_match_radix.py``
holds it against the plain version and the spec and describes the design;
its ``stats`` count the traced kernel's lookups and hits, to which
``tests/test_torch_cuda.py`` holds the card. It imports no JAX, so it runs
beside the card too.
"""

from __future__ import annotations

import collections
import pathlib
import re

import numpy as np
import torch

from pim_compression_tpu_torch.ops import hopper_match

MATCH_CU = pathlib.Path(hopper_match.__file__).parents[1] / "csrc" / "match.cu"
CONST = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", MATCH_CU.read_text())}
BINS, PASSES = CONST["kBins"], CONST["kPasses"]
HALF = 32768
SHARED_PER_CTA = 232448
SENTINEL = np.uint32(0xFFFFFFFF)
TABLE_SLOTS = 1 << 16  # a split rung's 16-bit keys
LANES = np.arange(32, dtype=np.uint32)
LANEMASK_LT = (np.uint64(1) << LANES.astype(np.uint64)) - np.uint64(1)


def block_threads(bs: int) -> int:
    """The kernel's CTA size: half the sort rows, whole warps, at most 1024."""
    half = min(hopper_match.sort_size(bs), HALF) // 2
    return min(max(half, 32), 1024)


def shared_bytes(bs: int) -> int:
    """The kernel's shared memory: the byte region, the sort words, every
    warp's column of counts ((kBins / 2) x (warps + 1) words), 32 totals."""
    nt = block_threads(bs)
    words = max(min(hopper_match.sort_size(bs), HALF), 2 * nt)
    region = max((bs + 64 + 15) // 16 * 16, 2 * words)
    return region + 4 * words + 4 * (BINS // 2) * (nt // 32 + 1) + 4 * 32


def digit_widths(pos_bits: int) -> tuple[int, ...]:
    return (9, 8) if pos_bits == 15 else (8, 8)


def wide_slot(d: np.ndarray, nw: int) -> np.ndarray:
    """radix.cuh's wide_slot: digit d's uint16 slot in a warp's column."""
    return 2 * (d >> 1) * (nw + 1) + (d & 1)


def _popc(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.int64)


def _ballot(bit: np.ndarray) -> np.ndarray:
    """[..., 32] of 0/1 -> [..., 1] uint32 masks, lane l at bit l."""
    return (bit.astype(np.uint64) << LANES.astype(np.uint64)).sum(-1, keepdims=True).astype(np.uint32)


def peers_of(d: np.ndarray, bits: int) -> np.ndarray:
    """[..., 32] digits -> each lane's peers as the AND of the digit's ballots
    or their complements; checked against __match_any_sync's masks."""
    peers = np.full(d.shape, 0xFFFFFFFF, np.uint32)
    for b in range(bits):
        m = _ballot((d >> b) & 1)
        peers &= np.where((d >> b) & 1, m, ~m)
    same = d[..., None, :] == d[..., :, None]  # [..., lane, other lane]
    match_any = (same.astype(np.uint64) << LANES.astype(np.uint64)).sum(-1).astype(np.uint32)
    assert np.array_equal(peers, match_any)
    return peers


def scan_wide_counts(hist: np.ndarray, bits: int, nw: int) -> None:
    """radix.cuh's scan_wide_counts, in place on the uint16 slots: thread t
    takes the 2^bits / 32 counts from t * 2^bits / 32 on in digit-major,
    warp-minor order, a warp scans its threads' sums, warp 0 the warp totals."""
    nt, per = 32 * nw, 1 << (bits - 5)
    k = np.arange(nt * per).reshape(nt, per)
    at = 2 * (k & (nw - 1)) + wide_slot(k >> (nw.bit_length() - 1), nw)
    c = hist[at]
    s = c.sum(1).reshape(nw, 32)
    incl = np.cumsum(s, axis=1)
    tot = incl[:, -1]
    run = (np.cumsum(tot) - tot)[:, None] + incl - s  # each thread's first offset
    prefix = run.reshape(nt, 1) + np.cumsum(c, axis=1) - c
    assert prefix.max() <= HALF  # fits a uint16
    hist[at] = prefix


def radix_sort(words: np.ndarray, nt: int, pos_bits: int, seed: int = 0) -> np.ndarray:
    """The kernel's radix_sort on words[0, steps * nt): two passes, each a
    count sweep of shared-memory adds into the warp's column, one
    digit-major scan, and a scatter to running offset + peer rank, one
    warp-step at a time. The counts start as garbage, as an earlier sort
    leaves them."""
    nw = nt // 32
    steps = len(words) // nt
    # uint16 slots of (kBins / 2) x (nw + 1) words; warp k's column starts at word k.
    hist = np.random.default_rng(seed).integers(0, 1 << 16, 2 * (BINS // 2) * (nw + 1)).astype(np.int64)
    warp = np.arange(nw)
    shift = pos_bits
    for bits in digit_widths(pos_bits):
        assert bits <= BINS.bit_length() - 1
        w = words.reshape(nw, steps, 32)  # warp k owns a contiguous slice, 32 rows a step
        d = ((w >> np.uint32(shift)) & np.uint32((1 << bits) - 1)).astype(np.int64)
        slot = 2 * warp[:, None, None] + wide_slot(d, nw)
        zeroed = 2 * (warp[:, None] + np.arange((1 << bits) // 2)[None, :] * (nw + 1))
        hist[zeroed] = hist[zeroed + 1] = 0  # each warp its own column's words
        np.add.at(hist, slot.ravel(), 1)  # the count sweep: an atomic add a word
        assert hist.max() < 1 << 16
        scan_wide_counts(hist, bits, nw)
        peers = peers_of(d, bits)
        rank = _popc(peers & LANEMASK_LT.astype(np.uint32))
        pos = np.empty(w.shape, np.int64)
        for i in range(steps):  # the scatter sweep, every warp at once
            base = hist[slot[:, i]]
            pos[:, i] = base + rank[:, i]
            lead = rank[:, i] == 0  # one lane per digit of the step: distinct slots
            hist[slot[:, i][lead]] = base[lead] + _popc(peers[:, i][lead])
        assert np.array_equal(np.sort(pos.ravel()), np.arange(len(words)))  # a permutation
        out = np.empty_like(words)
        out[pos.ravel()] = w.ravel()
        words = out
        shift += bits
    return words


def new_table(fill: str = "random", seed: int = 0) -> np.ndarray:
    """A block's table of each 16-bit key's last first-half index as the
    kernel finds it in device memory before its first split rung: never
    cleared, so ``"zeros"`` or ``"random"`` bytes from ``seed``."""
    if fill == "zeros":
        return np.zeros(TABLE_SLOTS, np.uint16)
    return np.random.default_rng(seed).integers(0, 1 << 16, TABLE_SLOTS).astype(np.uint16)


def kernel_prev_lags(h: np.ndarray, bs: int, stride: int, window: int, table: np.ndarray | None = None,
                     stats: collections.Counter | None = None) -> np.ndarray:
    """One block's uint16 lag plane of a rung as the kernel computes it, from
    the rung's 32-bit hashes h[0, bs). A rung that sorts its 32 KB halves in
    turn writes each key's last sorted index in the first half into
    ``table`` (the block's uint16[65536] slots, kept across rungs and
    calls; a fresh random one if None) and looks the second half's keys up
    there; ``stats`` counts the traced kernel's ``lookups`` and ``hits``,
    and ``stale`` lookups of a slot this rung did not write."""
    rows_pad = max(hopper_match.sort_size(bs) // stride, 1)
    pb = hopper_match.pos_bits(rows_pad)
    pos_mask = np.uint32((1 << pb) - 1)
    cnt = -(-bs // stride)
    group = window // stride if window and window // stride < rows_pad else rows_pad
    chunk = min(HALF, rows_pad)
    split = group > chunk
    if split:
        assert pb == 16 and cnt > HALF  # every key has a slot; the first half is whole
        table = new_table(seed=bs) if table is None else table
        written = np.zeros(TABLE_SLOTS, bool)
    nt = block_threads(bs)
    plane = np.zeros(bs, np.int64)
    first_half = None
    for r0 in range(0, cnt, chunk):
        real = min(chunk, cnt - r0)
        steps = -(-real // nt)
        assert steps <= 32  # the words a thread walks in a pass
        rows = np.arange(r0, r0 + real, dtype=np.uint32)
        hh = h[rows.astype(np.int64) * stride]
        key = (hh ^ (hh >> np.uint32(pb))) & np.uint32((1 << (32 - pb)) - 1)
        words = np.full(steps * nt, SENTINEL, np.uint32)
        words[:real] = (key << np.uint32(pb)) | rows
        s = radix_sort(words, nt, pb)[:real]
        assert not (s == SENTINEL).any()  # the sentinels sort past every real word
        row = (s & pos_mask).astype(np.int64)
        skey = s >> np.uint32(pb)
        prev_row = np.concatenate([[-1], row[:-1]])
        same = np.concatenate([[False], skey[1:] == skey[:-1]])
        prev = np.where(same & (prev_row // group == row // group), prev_row, -1)
        if split and r0 > 0:  # last_with_key: the key's slot, held to the word it points at
            look = ~same  # first of its key in its half
            w = first_half[table[skey] & (HALF - 1)]
            hit = look & ((w >> np.uint32(16)) == skey)
            prev = np.where(look, np.where(hit, (w & np.uint32(0xFFFF)).astype(np.int64), -1), prev)
            if stats is not None:
                stats["lookups"] += int(look.sum())
                stats["hits"] += int(hit.sum())
                stats["stale"] += int((look & ~written[skey]).sum())
        if split and r0 == 0:  # each key's last sorted index, by its one writer
            first_half = s.copy()
            last = np.concatenate([skey[1:] != skey[:-1], [True]])
            table[skey[last]] = np.flatnonzero(last)
            written[skey[last]] = True
        near = np.zeros(real, np.int64)  # lags by row, as the kernel stages them
        near[row - r0] = np.where(prev >= 0, (row - prev) * stride, 0)
        p = np.arange(r0 * stride, min(bs, (r0 + real) * stride))
        plane[p] = np.where((p - p[0]) % stride, 0, near[(p - p[0]) // stride])
    return plane


def plain_hashes(blocks: np.ndarray, rung: int) -> np.ndarray:
    """The rung's 32-bit hash at every position of uint8 blocks [n, bs],
    zero past each length, as uint32 [n, bs]: the hash ladder of
    ``hopper_match.match_blocks_torch``, with bytes past the block read as
    zero, as the kernel reads its zero pad."""
    h, span = hopper_match._word4(torch.from_numpy(blocks).long()), 4
    while span < rung:
        h = hopper_match._mul32(h, hopper_match.HASH_M1) ^ hopper_match._mul32(
            hopper_match._shift_up(h, span), hopper_match.HASH_M2)
        span *= 2
    return h.numpy().astype(np.uint32)
