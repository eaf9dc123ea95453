"""The port's sweep matcher against the JAX package's.

The plain PyTorch sweep (``hopper_sweep.sweep_match_torch``) is held
against the NumPy spec (``lane_model_encode.match_search`` for the sampled
coarse sweep, ``match_search_granular`` for the granular one) on every
length and lag, the sweep's encode stream against the spec's pipeline,
the interpret-mode Pallas kernels and the JAX runtime, exactly: the codec
is integer-only. Inputs are made from seeds. The CUDA kernel's tests are in
``test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu.ops import pallas_encode
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu_torch import TorchCodecConfig, runtime
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.ops import hopper_encode, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

# (block_size, match_window, coarse_window): windows 32, 64 and 100 (which
# rounds up to 128), coarse reaches 0, 544, 1088 and 1500 (cut to the block).
SIZES = [
    (256, 32, 0), (256, 64, 544), (384, 100, 1088), (384, 32, 544), (1024, 64, 544),
    (1024, 100, 1088), (1024, 32, 1500), (2048, 64, 1500), (2048, 100, 1088), (2048, 32, 0),
]


def _inputs(block_size: int, window: int, seed: int):
    """Text-like blocks (one cut short), snippet-repeat blocks of random
    lengths and the sweep's edge blocks (repeats at lags 1, window,
    window + 1 and 1237, runs cut at the block's length)."""
    text = np.frombuffer(streams.text_payload(3 * block_size, seed), np.uint8).reshape(3, block_size).copy()
    text_lens = np.array([block_size, block_size, block_size - 77], np.int32)
    text[2, block_size - 77 :] = 0
    rb, rl = streams.plain_blocks(block_size, 4, seed + 1)
    eb, el = streams.sweep_edge_blocks(block_size, window, seed + 2)
    return np.concatenate([text, rb, eb]), np.concatenate([text_lens, rl, el])


def _spec_match(blocks, lens, knobs):
    data = blocks.T.astype(np.int32)
    if knobs["granular"]:
        return lme.match_search_granular(data, lens, knobs["window"], knobs["coarse_window"])
    return lme.match_search(data, lens, knobs["window"], knobs["coarse_window"])


def _spec_encode(blocks, lens, knobs, cap):
    """The reference's sweep pipeline: match, lazy-1 (``_emit`` applies it
    for every matcher, pallas_encode.py:1261-1269), greedy parse, emit."""
    best_len, best_off = _spec_match(blocks, lens, knobs)
    deferred = lme.lazy_defer(best_len)
    accept, is_copy = lme.greedy_parse(deferred, lens)
    comp, sizes = lme.layout_and_emit(blocks.T.astype(np.int32), lens, accept, is_copy, deferred, best_off, cap)
    return comp.T, sizes


def _assert_same_blocks(comp, sizes, comp_ref, sizes_ref):
    np.testing.assert_array_equal(sizes, sizes_ref)
    for i, n in enumerate(sizes_ref):
        assert comp[i, :n].tobytes() == comp_ref[i, :n].tobytes(), f"block {i}"


@pytest.mark.parametrize("mode", ["sampled", "granular"])
@pytest.mark.parametrize("block_size, window, coarse", SIZES, ids=[f"{b}-w{w}-c{c}" for b, w, c in SIZES])
def test_sweep_match_matches_lane_model(block_size, window, coarse, mode):
    granular = mode == "granular"
    if granular and block_size % 256 and min(coarse, block_size) > (window + 31) // 32 * 32:
        with pytest.raises(ValueError, match="256"):  # the reference's envelope
            hopper_sweep.sweep_knobs(block_size, window, coarse, granular)
        return
    knobs = hopper_sweep.sweep_knobs(block_size, window, coarse, granular)
    assert knobs["window"] == (min(window, block_size) + 31) // 32 * 32
    blocks, lens = _inputs(block_size, knobs["window"], block_size + window + coarse)
    mlen, mlag = hopper_sweep.sweep_match_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
    assert mlen.dtype == torch.uint8 and mlag.dtype == torch.int16
    want_len, want_lag = _spec_match(blocks, lens, knobs)
    np.testing.assert_array_equal(mlen.numpy().astype(np.int32), want_len.T)
    np.testing.assert_array_equal(mlag.numpy().astype(np.int32), want_lag.T)
    assert int(mlen.max()) == 64 and (want_len > 0).sum() > len(lens) * 8  # the inputs do match


def test_sweep_knobs_normalise_as_the_reference():
    assert hopper_sweep.sweep_knobs(8192, 2048, 8192, True) == dict(window=2048, coarse_window=8192, granular=True)
    # Sampled: the coarse range becomes whole 256-lag chunks; at or below the window it is off.
    assert hopper_sweep.sweep_knobs(8192, 2048, 8191, False)["coarse_window"] == 2048 + 23 * 256
    assert hopper_sweep.sweep_knobs(8192, 100, 120, False) == dict(window=128, coarse_window=0, granular=False)
    assert hopper_sweep.sweep_knobs(256, 4096, 4096, True) == dict(window=256, coarse_window=0, granular=True)
    assert hopper_sweep.sweep_knobs(384, 64, 0, True)["coarse_window"] == 0  # granular off: any size
    for bad in [(32768, 512, 0, False), (8192, -1, 0, False), (384, 64, 300, True)]:
        with pytest.raises(ValueError):
            hopper_sweep.sweep_knobs(*bad)


def test_sweep_finds_an_unaligned_long_lag_only_when_granular():
    # A 100-byte repeat at lag 1237 (not a multiple of 8): past the window,
    # the sampled sweep cannot see it and the granular search finds it at
    # the next 8-aligned position.
    blocks, lens = streams.sweep_edge_blocks(2048, 64, 5)
    row = next(i for i in range(len(lens)) if (blocks[i, 1254:1354] == blocks[i, 17:117]).all())
    args = torch.from_numpy(blocks[row : row + 1]), torch.from_numpy(lens[row : row + 1])
    sampled = hopper_sweep.sweep_match_torch(*args, window=64, coarse_window=2048)
    granular = hopper_sweep.sweep_match_torch(*args, window=64, coarse_window=2048, granular=True)
    assert not (sampled[1] == 1237).any()
    p = 1256  # the first 8-aligned position of the copy
    assert int(granular[0][0, p]) == 64 and int(granular[1][0, p]) == 1237


@pytest.mark.parametrize("mode", ["sampled", "granular"])
@pytest.mark.parametrize("block_size", [256, 1024, 2048])
def test_sweep_encode_matches_spec_pipeline(block_size, mode):
    knobs = hopper_sweep.sweep_knobs(block_size, 64, 1500, mode == "granular")
    blocks, lens = _inputs(block_size, knobs["window"], 3 * block_size)
    cap = pipeline.padded_capacity(block_size)
    comp, sizes = hopper_encode.encode_blocks_torch(
        torch.from_numpy(blocks), torch.from_numpy(lens), cap=cap, matcher="sweep", **knobs
    )
    if mode == "sampled":  # lane_model_encode's own pipeline for the sweep
        comp_ref, sizes_ref = lme.encode_lanes(
            blocks, lens, block_size, cap, window=knobs["window"], coarse_window=knobs["coarse_window"],
            matcher="sweep",
        )
        _assert_same_blocks(comp.numpy(), sizes.numpy(), comp_ref, sizes_ref)
    comp_ref, sizes_ref = _spec_encode(blocks, lens, knobs, cap)
    _assert_same_blocks(comp.numpy(), sizes.numpy(), comp_ref, sizes_ref)


@pytest.mark.parametrize(
    "mode, window, coarse", [("sampled", 64, 0), ("granular", 32, 128)], ids=["sampled-w64", "granular-w32-c128"]
)
def test_sweep_encode_matches_pallas_interpret(mode, window, coarse):
    # The JAX function itself, as tests/test_pallas_encode.py runs it on the
    # CPU: one 128-block group at bs 256 (the interpret-mode granule kernel's
    # time grows with the coarse lags, so the granular case takes 96 of them).
    import jax.numpy as jnp

    bs = 256
    knobs = hopper_sweep.sweep_knobs(bs, window, coarse, mode == "granular")
    eb, el = streams.sweep_edge_blocks(bs, knobs["window"], 7)
    rb, rl = streams.plain_blocks(bs, pallas_encode.LANES - len(el), 256 + window)
    blocks, lens = np.concatenate([rb, eb]), np.concatenate([rl, el])
    comp_k, sizes_k = pallas_encode.encode_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(lens), block_size=bs, matcher="sweep", window=window,
        coarse_window=coarse, granular=mode == "granular", interpret=True,
    )
    comp, sizes = hopper_encode.encode_blocks_torch(
        torch.from_numpy(blocks), torch.from_numpy(lens), cap=pipeline.padded_capacity(bs), matcher="sweep", **knobs
    )
    _assert_same_blocks(comp.numpy(), sizes.numpy(), np.asarray(comp_k), np.asarray(sizes_k))
    if mode == "granular":  # the coarse search found matches past the window
        mlen, mlag = hopper_sweep.sweep_match_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
        assert ((mlag.long() > knobs["window"]) & (mlen >= 8)).sum() > 100


def test_torch_compress_sweep_equals_jax_pallas_stream():
    # The whole stream (triage, raw frames, sweep encode, assembly) against
    # the JAX runtime's pallas engine at bs 256 (the interpret-mode granule
    # kernel alone takes about a minute here, so this runs the fine sweep).
    from pim_compression_tpu import runtime as ref_runtime

    rng = np.random.default_rng(21)
    text = streams.text_payload(40 * 256, 22)
    data = text[: 10 * 256] + rng.integers(0, 256, 256, dtype=np.uint8).tobytes() + text[10 * 256 :] + b"tail"
    knobs = dict(block_size=256, batch_blocks=128, matcher="sweep", match_window=64)
    ref_timer = ref_runtime.PhaseTimer()
    want = ref_runtime.compress(data, CodecConfig(engine="pallas", **knobs), ref_timer)
    timer = runtime.PhaseTimer()
    got = runtime.compress(data, TorchCodecConfig(engine="torch", verify=True, **knobs), timer)
    assert bytes(got) == bytes(want)
    assert timer.notes == ref_timer.notes == {}  # a 256-byte random block stays under the triage's entropy bar
    assert oracle.decompress(bytes(got)) == data


@pytest.mark.parametrize(
    "knobs",
    [dict(block_size=32768), dict(block_size=16384 + 128), dict(block_size=384, match_window=64, coarse_window=1000, coarse_mode="granular")],
    ids=["bs-32768", "bs-16512", "granular-bs-384"],
)
def test_sweep_outside_its_envelope_raises(knobs):
    from pim_compression_tpu_torch.ops import hopper_match
    from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

    launches = hopper_sweep.LAUNCHES, hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    with pytest.raises(SnappyError) as e:
        runtime.compress(b"outside the sweep envelope " * 100, TorchCodecConfig(engine="torch", matcher="sweep", **knobs))
    assert e.value.status == SnappyStatus.BAD_ARGUMENT and "sweep envelope" in str(e.value)
    assert (hopper_sweep.LAUNCHES, hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == launches


def test_sweep_match_wrapper_on_the_cpu():
    blocks, lens = streams.sweep_edge_blocks(1024, 64, 9)
    args = torch.from_numpy(blocks), torch.from_numpy(lens)
    launches = hopper_sweep.LAUNCHES
    got = hopper_sweep.sweep_match(*args, window=64, coarse_window=1024, granular=True)
    want = hopper_sweep.sweep_match_torch(*args, window=64, coarse_window=1024, granular=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert hopper_sweep.LAUNCHES == launches  # the CPU takes the plain version
    with pytest.raises(ValueError):
        hopper_sweep.sweep_match(args[0], args[1].long())
    with pytest.raises(ValueError):
        hopper_sweep.sweep_match(args[0].to("meta"), args[1].to("meta"))
