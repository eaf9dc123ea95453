"""A NumPy mirror of the match kernel's rung sort, held against the plain version and the spec.

``csrc/match.cu`` ranks each rung's words ``(key << pos_bits) | row`` by a
stable LSD radix sort of the key field (6+6+5 bit digits at ``pos_bits`` 15,
6+5+5 at 16), each warp owning a contiguous slice of the buffer and walking
it 32 rows a step: per pass the lanes count the digits they own from the
warp's ballots, the counts are scanned digit-major and warp-minor, and each
word goes to its digit's running offset plus its rank among its ballot
peers. A row's candidate is its sorted predecessor when the keys are equal,
dropped when it lies before the row's window group; at 64 KB the second
32 KB half falls back to a binary search of the sorted first half. The
mirror below follows those steps, array by array, so that a fault of the
design shows here on the CPU. It must equal ``hopper_match._prev_lags`` and
``lane_model_encode.packed_prev_lags`` on every position. Exact: integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu_torch.ops import hopper_match
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

HALF = 32768
SENTINEL = np.uint32(0xFFFFFFFF)
LANES = np.arange(32, dtype=np.uint32)
LANEMASK_LT = (np.uint64(1) << LANES.astype(np.uint64)) - np.uint64(1)


def block_threads(bs: int) -> int:
    """The kernel's CTA size: half the sort rows, whole warps, at most 1024."""
    half = min(hopper_match.sort_size(bs), HALF) // 2
    return min(max(half, 32), 1024)


def digit_widths(pos_bits: int) -> tuple[int, int, int]:
    return (6, 6, 5) if pos_bits == 15 else (6, 5, 5)


def _popc(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.int64)


def _ballot(bit: np.ndarray) -> np.ndarray:
    """[..., 32] of 0/1 -> [..., 1] uint32 masks, lane l at bit l."""
    return (bit.astype(np.uint64) << LANES.astype(np.uint64)).sum(-1, keepdims=True).astype(np.uint32)


def radix_sort(words: np.ndarray, nt: int, pos_bits: int) -> np.ndarray:
    """The kernel's radix_sort on words[0, steps * nt): three passes, each a
    count sweep of lane-owned digit masks, one digit-major scan, and a
    scatter to running offset + ballot-peer rank."""
    nw = nt // 32
    steps = len(words) // nt
    shift = pos_bits
    for bits in digit_widths(pos_bits):
        w = words.reshape(nw, steps, 32)  # warp k owns a contiguous slice, 32 rows a step
        d = (w >> np.uint32(shift)) & np.uint32((1 << bits) - 1)
        peers = np.full(w.shape, 0xFFFFFFFF, np.uint32)
        own = np.full(w.shape, 0xFFFFFFFF, np.uint32)
        for b in range(5):
            m = _ballot((d >> np.uint32(b)) & 1)
            peers &= np.where((d >> np.uint32(b)) & 1, m, ~m)
            own &= np.where((LANES >> np.uint32(b)) & 1, m, ~m)
        m5 = _ballot((d >> np.uint32(5)) & 1) if bits > 5 else np.zeros((nw, steps, 1), np.uint32)
        peers &= np.where((d >> np.uint32(5)) & 1, m5, ~m5)
        own_lo, own_hi = own & ~m5, own & m5
        hist = np.zeros(64 * nw, np.int64)  # digit-major, warp-minor
        warp = np.arange(nw)[:, None]
        hist[LANES[None, :] * nw + warp] = _popc(own_lo).sum(axis=1)
        hist[(LANES[None, :] + 32) * nw + warp] = _popc(own_hi).sum(axis=1)
        offs = np.cumsum(hist) - hist
        run = []
        for bins, owned in ((LANES, own_lo), (LANES + 32, own_hi)):
            steps_before = np.cumsum(_popc(owned), axis=1) - _popc(owned)
            run.append(offs[bins[None, :] * nw + warp][:, None, :] + steps_before)
        src = (d & 31).astype(np.int64)  # the lane that owns the digit's offset
        lo, hi = (np.take_along_axis(r, src, axis=2) for r in run)
        pos = np.where(d < 32, lo, hi) + _popc(peers & LANEMASK_LT.astype(np.uint32))
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
        assert sum(digit_widths(pos_bits)) == 32 - pos_bits and max(digit_widths(pos_bits)) <= 6


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
