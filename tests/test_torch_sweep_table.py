"""The NumPy mirror of the sweep kernel's table walk, held against the plain version and the spec.

``pim_compression_tpu_torch/utils/sweep_table.py`` follows ``csrc/sweep.cu``
step by step: the words and their hashed keys, the stable radix rank of
``(key << kPosBits) | p``, the nearest-first walk down a position's chain
with its phase filters (the window, the sampled stride, the granular
8-aligned reach and its 2-word floor), the collision skip, the last-word
reject, the exact early exit, the lane budget and the warp's 32-entry
rounds. Its lengths and lags must equal ``hopper_sweep.sweep_match_torch``
and the reference's ``lane_model_encode.match_search`` (fine and sampled)
and ``match_search_granular`` (granular) on every position, exactly:
integers. Inputs are made from seeds: text, snippet-repeat blocks, the
sweep's edge blocks and its hard blocks (one word repeated, zeros, a word
at every 8-aligned position, two letters, forced key collisions). The
mirror's constants are the kernel's, read from its source.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu_torch.ops import hopper_sweep
from pim_compression_tpu_torch.utils import streams, sweep_table

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

SHARED_PER_SM = 233472  # bytes of shared memory on an H100 SM
SHARED_PER_CTA = 232448  # the most one CTA may take
SHARED_RESERVED_PER_CTA = 1024

# (block_size, match_window, coarse_window): the main config (2048 / 8192 at
# 8 KB), w512 / c4096, and sizes from 256 to the 16384 envelope.
SIZES = [(256, 32, 256), (1024, 64, 544), (2048, 128, 2048), (4096, 512, 4096), (8192, 2048, 8192),
         (16384, 64, 1024)]
MODES = ["fine", "sampled", "granular"]
PLAIN_LIMIT = 2048  # the plain version loops over lags in PyTorch: seconds a block above this


def knobs_for(block_size: int, window: int, coarse: int, mode: str) -> dict:
    return hopper_sweep.sweep_knobs(block_size, window, 0 if mode == "fine" else coarse, mode == "granular")


def inputs(block_size: int, window: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Text (one cut short), snippet repeats, the edge blocks and the hard
    blocks, zero past each length."""
    text = np.frombuffer(streams.text_payload(2 * block_size, seed), np.uint8).reshape(2, block_size).copy()
    text_lens = np.array([block_size, block_size - 77], np.int32)
    parts = [(text, text_lens), streams.plain_blocks(block_size, 3 if block_size <= 2048 else 1, seed + 1),
             streams.sweep_edge_blocks(block_size, window, seed + 2),
             streams.sweep_hard_blocks(block_size, window, seed + 3)]
    blocks = np.concatenate([b for b, _ in parts])
    lens = np.concatenate([n for _, n in parts])
    return np.where(np.arange(block_size)[None, :] < lens[:, None], blocks, 0).astype(np.uint8), lens


def spec(blocks, lens, knobs) -> tuple[np.ndarray, np.ndarray]:
    data = blocks.T.astype(np.int32)
    if knobs["granular"]:
        got = lme.match_search_granular(data, lens, knobs["window"], knobs["coarse_window"])
    else:
        got = lme.match_search(data, lens, knobs["window"], knobs["coarse_window"])
    return got[0].T, got[1].T


def test_constants_are_the_kernels():
    c = sweep_table.CONST
    assert {k: c[k] for k in ("kThreads", "kPosBits", "kDigitBits", "kPasses", "kBudget", "kMaxWords")} == {
        "kThreads": 1024, "kPosBits": 14, "kDigitBits": 6, "kPasses": 2, "kBudget": 8, "kMaxWords": 16,
    }
    assert c["kCoarseStep"] == hopper_sweep.COARSE_STEP and c["kMaxBlockSize"] == hopper_sweep.MAX_SWEEP_BLOCK
    assert c["kPosBits"] + c["kPasses"] * c["kDigitBits"] <= 32  # a key and a position fit a word
    assert c["kHashMul"] % 2 == 1  # odd: the key of a word is a bijection's top bits
    # Shared memory: W and two sort buffers of 4 bytes a table row, the
    # digit counts and the scan totals. Two CTAs fit an SM at 8 KB, one at 16 KB.
    warps = c["kThreads"] // 32

    def footprint(bs):
        rows = -(-bs // c["kThreads"]) * c["kThreads"]
        return 12 * rows + 2 * (1 << c["kDigitBits"]) * warps + 4 * 32

    assert footprint(8192) == 102528 and footprint(16384) == 200832 <= SHARED_PER_CTA
    assert SHARED_PER_SM // (footprint(8192) + SHARED_RESERVED_PER_CTA) == 2
    assert rows_fit(hopper_sweep.MAX_SWEEP_BLOCK)


def rows_fit(bs: int) -> bool:
    return -(-bs // sweep_table.THREADS) * sweep_table.THREADS <= 1 << sweep_table.POS_BITS


@pytest.mark.parametrize("n, threads, key_bits", [(1024, 1024, 12), (8192, 1024, 12), (16384, 1024, 12),
                                                  (8192, 512, 2), (1024, 64, 5)])
def test_radix_rank_is_stable_on_the_key_field(n, threads, key_bits):
    rng = np.random.default_rng(n + key_bits)
    key = rng.integers(0, 1 << key_bits, (3, n)).astype(np.uint32)
    key[:, -7:] = (1 << key_bits) - 1  # sentinel keys, and real ones equal to them
    p = np.arange(n, dtype=np.uint32)
    table = sweep_table.radix_rank((key << np.uint32(sweep_table.POS_BITS)) | p, threads)
    for row in range(3):
        order = np.argsort(key[row], kind="stable")
        np.testing.assert_array_equal(table[row] & np.uint32((1 << sweep_table.POS_BITS) - 1), order)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block_size, window, coarse", SIZES, ids=[f"{b}-w{w}-c{c}" for b, w, c in SIZES])
def test_mirror_matches_plain_and_spec(block_size, window, coarse, mode):
    knobs = knobs_for(block_size, window, coarse, mode)
    blocks, lens = inputs(block_size, knobs["window"], block_size + window)
    stats = collections.Counter()
    mlen, mlag = sweep_table.sweep_table(blocks, lens, knobs["window"], knobs["coarse_window"], knobs["granular"],
                                         stats=stats)
    want_len, want_lag = spec(blocks, lens, knobs)
    np.testing.assert_array_equal(mlen.astype(np.int32), want_len)
    np.testing.assert_array_equal(mlag.astype(np.int32), want_lag)
    if block_size <= PLAIN_LIMIT:
        plain_len, plain_lag = hopper_sweep.sweep_match_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
        np.testing.assert_array_equal(mlen, plain_len.numpy())
        np.testing.assert_array_equal(mlag, plain_lag.numpy())
    assert int(mlen.max()) == 64 and stats["handed_off"] > 0  # long matches, and chains past the budget


@pytest.mark.parametrize("mode", MODES)
def test_budget_threads_and_key_width_leave_the_output_unchanged(mode):
    # The lane budget only moves work between a lane and its warp's rounds,
    # the CTA's width only the sort's slices, and a narrower key only adds
    # collisions, which the walk skips: the output stays the spec's.
    knobs = knobs_for(2048, 128, 2048, mode)
    blocks, lens = inputs(2048, knobs["window"], 31)
    want = spec(blocks, lens, knobs)
    args = (blocks, lens, knobs["window"], knobs["coarse_window"], knobs["granular"])
    full = sweep_table.KEY_BITS
    for budget, threads, key_bits in [(1, 1024, full), (2, 1024, full), (7, 64, full), (10**6, 1024, full),
                                      (32, 1024, 3), (1, 1024, 5), (32, 512, full)]:
        stats = collections.Counter()
        mlen, mlag = sweep_table.sweep_table(*args, budget=budget, threads=threads, key_bits=key_bits, stats=stats)
        np.testing.assert_array_equal(mlen.astype(np.int32), want[0])
        np.testing.assert_array_equal(mlag.astype(np.int32), want[1])
        assert (stats["handed_off"] > 0) == (budget < 10**6)
        if key_bits <= 5:
            assert stats["collisions"] > stats["walks"]  # more collisions than walks


def test_mirror_meets_every_edge():
    # Each rule of the walk decides some entry of these inputs: the lane's
    # and the round's exits at the top, the handoff, a collision, a sampled
    # lag off the stride, the last-word reject, a 1-word run in the granular reach.
    totals = collections.Counter()
    for mode in ("sampled", "granular"):
        knobs = knobs_for(2048, 128, 2048, mode)
        blocks, lens = inputs(2048, knobs["window"], 5)
        sweep_table.sweep_table(blocks, lens, knobs["window"], knobs["coarse_window"], knobs["granular"],
                                budget=4, stats=totals)
    for edge in ("lane_exits", "round_exits", "handed_off", "rounds", "collisions", "sampled_filtered",
                 "last_word_rejects", "short_granular_runs"):
        assert totals[edge] > 0, edge


def test_handoff_cuts_a_warps_steps_on_text():
    # The main config on text: a warp waits for its longest walk, so capping
    # a lane's walk and sharing the rest cuts the steps a warp takes.
    knobs = knobs_for(8192, 2048, 8192, "granular")
    blocks = np.frombuffer(streams.text_payload(4 * 8192, 20261016), np.uint8).reshape(4, 8192).copy()
    lens = np.full(4, 8192, np.int32)
    steps = {}
    for budget in (sweep_table.BUDGET, 10**6):
        stats = collections.Counter()
        sweep_table.sweep_table(blocks, lens, knobs["window"], knobs["coarse_window"], True, budget=budget, stats=stats)
        steps[budget] = stats["warp_steps"] / stats["warps"]
        assert stats["lane_steps"] + 32 * stats["rounds"] >= stats["walks"]
    assert steps[sweep_table.BUDGET] < 0.75 * steps[10**6]


@pytest.mark.parametrize("mode", MODES)
def test_sweep_pairs_count_an_exhaustive_walk(mode):
    # The bound's count of work (hopper_sweep.sweep_pairs) against a walk of
    # every lag, position by position, up to the exact early exit.
    knobs = knobs_for(512, 64, 512, mode)
    window, coarse, granular = knobs["window"], knobs["coarse_window"], knobs["granular"]
    blocks, lens = inputs(512, window, 17)
    mlen, mlag = hopper_sweep.sweep_match_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
    got = hopper_sweep.sweep_pairs(torch.from_numpy(blocks), torch.from_numpy(lens), mlen, mlag, **knobs)
    w = sweep_table.words(blocks, lens, 512).astype(np.int64)
    visited = first_word = 0
    for b, p in zip(*np.nonzero(np.arange(512)[None, :] + 4 <= lens[:, None])):
        room = int(lens[b]) - p
        lags = list(range(1, min(window, p) + 1))
        if coarse and not granular:
            lags += range(window + 8, min(coarse, p) + 1, 8)
        elif coarse and p % 8 == 0 and room >= 8:
            lags += range(window + 1, min(coarse, p) + 1)
        top = int(sweep_table.bucket(np.array(min(16, room >> 2))))
        if mlen[b, p] == top:
            lags = lags[: lags.index(int(mlag[b, p])) + 1]
        visited += len(lags)
        first_word += sum(int(w[b, p] == w[b, p - d]) for d in lags)
    assert got == (visited, first_word)
