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
row's window group; at 64 KB a second-half row first of its key in its
half takes the first half's last word with its key, from a table of each
16-bit key's last sorted index that the first half's sweep writes and that
is never cleared, each slot read held to the word it points at. The mirror
(``tests/match_radix_mirror.py``) follows those steps, array by array and
in the kernel's shared-memory layout, so that a fault of the design shows
here on the CPU. It must equal ``hopper_match._prev_lags`` and
``lane_model_encode.packed_prev_lags`` on every position, whatever the
table held before. Exact: integers.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu_torch.ops import hopper_match
from pim_compression_tpu_torch.utils import streams

from match_radix_mirror import (
    BINS, HALF, PASSES, SENTINEL, SHARED_PER_CTA, block_threads, digit_widths, kernel_prev_lags, new_table,
    plain_hashes, radix_sort, shared_bytes,
)

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)


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


TABLES = ["zeros", "random", "stale"]


@pytest.mark.parametrize("table", TABLES)
def test_mirror_split_sort_at_64k(table):
    # bs 65536, stride 1, no window: each 32 KB half sorted in turn, the
    # second half looking its keys up in the table of the first half's last
    # indices; 16-bit keys. The table is never cleared: it starts as zeros,
    # as random bytes, or as another block's first half left it, and each
    # block runs rung 16 after rung 4, so that rung 16 meets rung 4's
    # entries, indices that point into a first half but at other keys.
    bs = 65536
    far = np.frombuffer(streams.far_repeat_block(bs, 5), np.uint8)
    text = np.frombuffer(streams.text_payload(bs, 5), np.uint8)
    blocks = np.stack([far, text, np.zeros(bs, np.uint8)])
    stats = collections.Counter()
    for rung in (4, 16):
        h = _hashes(blocks, rung)
        want = lme.packed_prev_lags(h, 1)[0].T
        h32 = h.T.view(np.uint32)
        np.testing.assert_array_equal(plain_hashes(blocks, rung), h32)
        plain = hopper_match._prev_lags(torch.from_numpy(h32.astype(np.int64)), 1)[0].numpy()
        np.testing.assert_array_equal(plain, want)
        if rung == 4:
            tables = [new_table(table, seed=i) for i in range(len(blocks))]
            if table == "stale":  # another block's first half, then this block's rung 4
                for i in range(len(blocks)):
                    kernel_prev_lags(h32[(i + 1) % len(blocks)], bs, 1, 0, tables[i])
        for i in range(len(blocks)):
            got = kernel_prev_lags(h32[i], bs, 1, 0, tables[i], stats)
            np.testing.assert_array_equal(got, want[i], err_msg=f"rung {rung}, block {i}")
        if rung == 4:
            p = np.arange(HALF, bs)
            assert (want[0, HALF:] > p - HALF).sum() > 1000  # lags that only the first-half lookup finds
    assert 0 < stats["hits"] < stats["lookups"]
    assert stats["stale"] > 0  # slots this rung did not write were read, and rejected
