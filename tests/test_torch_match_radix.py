"""A NumPy mirror of the match kernel's rung sort, held against the plain version and the spec.

``csrc/match.cu`` ranks each rung's words ``(key << pos_bits) | row`` by a
stable LSD radix sort of the key field in two passes (9+8 bit digits at
``pos_bits`` 15, 8+8 at 16), each warp owning a contiguous slice of the
buffer and walking it 32 rows a step: per pass each warp zeroes its column of
digit counts in shared memory and adds one to its digit's count for every
word, the counts are scanned digit-major and warp-minor, one run of adjacent
counts a thread, and each word goes to its digit's running offset in its
warp's column plus its rank among its peers (the lanes of its step with its
digit), the lowest peer moving the offset on. A row's candidate is its
sorted predecessor when the keys are equal, dropped when it lies before the
row's window group; at 64 KB the second 32 KB half falls back to a binary
search of the sorted first half. The mirror below follows those steps,
array by array and in the kernel's shared-memory layout, so that a fault of
the design shows here on the CPU. It must equal ``hopper_match._prev_lags``
and ``lane_model_encode.packed_prev_lags`` on every position. Exact:
integers.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu_torch.ops import hopper_match
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

MATCH_CU = pathlib.Path(hopper_match.__file__).parents[1] / "csrc" / "match.cu"
CONST = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", MATCH_CU.read_text())}
BINS, PASSES = CONST["kBins"], CONST["kPasses"]
HALF = 32768
SHARED_PER_CTA = 232448
SENTINEL = np.uint32(0xFFFFFFFF)
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


def kernel_prev_lags(h: np.ndarray, bs: int, stride: int, window: int) -> np.ndarray:
    """One block's uint16 lag plane of a rung as the kernel computes it, from
    the rung's 32-bit hashes h[0, bs)."""
    rows_pad = max(hopper_match.sort_size(bs) // stride, 1)
    pb = hopper_match.pos_bits(rows_pad)
    pos_mask = np.uint32((1 << pb) - 1)
    cnt = -(-bs // stride)
    group = window // stride if window and window // stride < rows_pad else rows_pad
    chunk = min(HALF, rows_pad)
    split = group > chunk
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
        prev_row = np.concatenate([[-1], row[:-1]])
        same = np.concatenate([[False], (s[1:] >> np.uint32(pb)) == (s[:-1] >> np.uint32(pb))])
        prev = np.where(same & (prev_row // group == row // group), prev_row, -1)
        if split and r0 > 0:  # last_with_key: an upper bound on the key field of the first half
            fkeys = first_half >> np.uint32(pb)
            lo = np.searchsorted(fkeys, s >> np.uint32(pb), side="right")
            hit = (lo > 0) & (fkeys[np.maximum(lo - 1, 0)] == (s >> np.uint32(pb)))
            far = np.where(hit, (first_half[np.maximum(lo - 1, 0)] & pos_mask).astype(np.int64), -1)
            prev = np.where(same, prev, far)
        if split and r0 == 0:
            first_half = s.copy()
        near = np.zeros(real, np.int64)  # lags by row, as the kernel stages them
        near[row - r0] = np.where(prev >= 0, (row - prev) * stride, 0)
        p = np.arange(r0 * stride, min(bs, (r0 + real) * stride))
        plane[p] = np.where((p - p[0]) % stride, 0, near[(p - p[0]) // stride])
    return plane


def _blocks(bs: int, seed: int) -> np.ndarray:
    """Text, all-zero, one-byte, partial, tail-repeat and random blocks,
    zero past each length as the kernel stages them."""
    hb, hl = streams.hand_plain_blocks(bs, seed)
    text = np.frombuffer(streams.text_payload(bs, seed), np.uint8)[None]
    blocks = np.concatenate([text, hb])
    lens = np.concatenate([[bs], hl])
    return np.where(np.arange(bs)[None, :] < lens[:, None], blocks, 0).astype(np.uint8)


def _hashes(blocks: np.ndarray, rung: int) -> np.ndarray:
    """The spec's rung hashes on the blocks padded to the sort size, [n, lanes] int32."""
    bs = blocks.shape[1]
    padded = np.zeros((len(blocks), hopper_match.sort_size(bs)), np.int32)
    padded[:, :bs] = blocks
    h, span = lme._pack_word4(padded.T), 4
    while span < rung:
        h = lme._hash_ladder_step(h, span)
        span *= 2
    return h


CASES = [
    (bs, stride, window)
    for bs in (1024, 24576, 32768, 40960)
    for stride in (1, 2, 4, 8)
    for window in (0, 512, 8192, 16384)
    if window == 0 or hopper_match.sort_size(bs) % window == 0
]


@pytest.mark.parametrize("bs, stride, window", CASES, ids=[f"bs{b}-s{s}-w{w}" for b, s, w in CASES])
def test_mirror_prev_lags_match_plain_and_spec(bs, stride, window):
    blocks = _blocks(bs, bs + 7 * stride + window)
    for rung in (4, 16):
        h = _hashes(blocks, rung)  # [n, lanes]
        want = lme.packed_prev_lags(h, 1, stride=stride, window=window // stride if window else 0)[0][:bs].T
        h32 = h[:bs].T.view(np.uint32)
        plain = hopper_match._prev_lags(torch.from_numpy(h32.astype(np.int64)), 1, stride, window)[0].numpy()
        np.testing.assert_array_equal(plain, want)
        for i in range(len(blocks)):
            got = kernel_prev_lags(h32[i], bs, stride, window)
            np.testing.assert_array_equal(got, want[i], err_msg=f"rung {rung}, block {i}")
        assert (want > 0).sum() > bs // stride  # the blocks do have candidates


@pytest.mark.parametrize("pos_bits", [15, 16])
@pytest.mark.parametrize("real, nt", [(1, 32), (40, 32), (256, 128), (5000, 1024), (16384, 1024), (32768, 1024)])
def test_radix_sort_is_stable_on_the_key_field(pos_bits, real, nt):
    rng = np.random.default_rng(real + pos_bits)
    steps = -(-real // nt)
    keys = rng.integers(0, 1 << (32 - pos_bits), real, dtype=np.uint32)
    keys[rng.random(real) < 0.5] = keys[0]  # many equal keys: stability decides their order
    keys[-1] = (1 << (32 - pos_bits)) - 1  # a real word with all-ones digits, before the sentinels
    rows = np.arange(real, dtype=np.uint32)
    words = np.full(steps * nt, SENTINEL, np.uint32)
    words[:real] = (keys << np.uint32(pos_bits)) | rows
    got = radix_sort(words, nt, pos_bits)
    np.testing.assert_array_equal(got[:real], words[:real][np.argsort(keys, kind="stable")])
    assert (got[real:] == SENTINEL).all()


def test_radix_digits_cover_the_key_field():
    for pos_bits in (15, 16):
        widths = digit_widths(pos_bits)
        assert sum(widths) == 32 - pos_bits and len(widths) == PASSES
        assert 1 << max(widths) <= BINS and min(widths) > 5  # scan_wide_counts: 2^bits / 32 counts a thread


TIES = ["one-key", "one-low-digit", "one-high-digit", "paired-digits", "lane-groups", "all-ones-keys"]


@pytest.mark.parametrize("pos_bits", [15, 16])
@pytest.mark.parametrize("real, nt", [(1000, 32), (32768, 1024)])
@pytest.mark.parametrize("pattern", TIES)
def test_radix_sort_is_stable_on_ties_in_a_warp_step(pattern, real, nt, pos_bits):
    # Many lanes of one warp-step share a digit: the peer rank and the
    # lowest peer's update of the running offset decide their order.
    rng = np.random.default_rng(len(pattern) + real + pos_bits)
    low, high = digit_widths(pos_bits)
    lo = rng.integers(0, 1 << low, real, dtype=np.uint32)
    hi = rng.integers(0, 1 << high, real, dtype=np.uint32)
    lane = np.arange(real, dtype=np.uint32) % 32
    if pattern == "one-key":
        lo[:], hi[:] = lo[0], hi[0]
    elif pattern == "one-low-digit":
        lo[:] = lo[0]
    elif pattern == "one-high-digit":
        hi[:] = hi[0]
    elif pattern == "paired-digits":  # d and d ^ 1 share a count word
        lo, hi = (lo[0] & ~np.uint32(1)) | (lane & 1), (hi[0] & ~np.uint32(1)) | ((lane >> 1) & 1)
    elif pattern == "lane-groups":  # runs of 4 lanes on one of 3 keys
        pick = rng.integers(0, 3, real // 4 + 1)[np.arange(real) // 4]
        lo, hi = lo[:3][pick], hi[:3][pick]
    else:  # the sentinels' digits, on real words
        lo[:], hi[:] = (1 << low) - 1, (1 << high) - 1
        lo[::3] = 0
    keys = (hi << np.uint32(low)) | lo
    steps = -(-real // nt)
    rows = np.arange(real, dtype=np.uint32)
    words = np.full(steps * nt, SENTINEL, np.uint32)
    words[:real] = (keys << np.uint32(pos_bits)) | rows
    got = radix_sort(words, nt, pos_bits, seed=real)
    np.testing.assert_array_equal(got[:real], words[:real][np.argsort(keys, kind="stable")])
    assert (got[real:] == SENTINEL).all()


def test_shared_bytes_fit_one_cta_of_1024_threads():
    assert (shared_bytes(32768), shared_bytes(65536)) == (230528, 230592)
    assert max(shared_bytes(bs) for bs in range(128, 65537, 128)) <= SHARED_PER_CTA
    assert block_threads(32768) == block_threads(65536) == 1024


def test_mirror_split_sort_at_64k():
    # bs 65536, stride 1, no window: each 32 KB half sorted in turn, the
    # second half searching the first; 16-bit keys.
    bs = 65536
    far = np.frombuffer(streams.far_repeat_block(bs, 5), np.uint8)
    text = np.frombuffer(streams.text_payload(bs, 5), np.uint8)
    blocks = np.stack([far, text, np.zeros(bs, np.uint8)])
    h = _hashes(blocks, 4)
    want = lme.packed_prev_lags(h, 1)[0].T
    h32 = h.T.view(np.uint32)
    for i in range(len(blocks)):
        np.testing.assert_array_equal(kernel_prev_lags(h32[i], bs, 1, 0), want[i])
    p = np.arange(HALF, bs)
    assert (want[0, HALF:] > p - HALF).sum() > 1000  # lags that only the first-half search finds
