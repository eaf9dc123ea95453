"""The port's block encode against the JAX package's encode.

The plain PyTorch match finder (``match_blocks_torch``) and emitter
(``emit_blocks_torch``) are held against the NumPy spec
``lane_model_encode`` and against the Pallas kernels in interpret mode,
exactly: the codec is integer-only, so every match length and lag, every
size and every byte below a size must be equal. Inputs are generated from
seeds. The CUDA kernels' tests are in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pim_compression_tpu.format import oracle
from pim_compression_tpu.format.varint import encode_varint32
from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu.ops import pallas_encode
from pim_compression_tpu.utils.config import preset_overrides
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

MAIN = dict(rungs=(4, 16), ext_cap=48, neighbor=True, max_lag=8192)  # the main path's knobs
CONFIGS = {
    "main": MAIN,
    "lag128": dict(rungs=(4, 16), ext_cap=48, neighbor=True, max_lag=128),
    "rungs-4-16-64": dict(rungs=(4, 16, 64), ext_cap=64, neighbor=False, max_lag=0),
}


def _inputs(block_size: int, seed: int, num_random: int = 24):
    """Random blocks plus the hand-built ones (with a repeat just past lag 128)."""
    rb, rl = streams.plain_blocks(block_size, num_random, seed)
    hb, hl = streams.hand_plain_blocks(block_size, seed, far_lag=129)
    return np.concatenate([rb, hb]), np.concatenate([rl, hl])


def _spec_match(blocks, lens, cfg):
    return lme.match_search_sorted(
        blocks.T.astype(np.int32), lens, rungs=cfg["rungs"], ext_cap=cfg["ext_cap"],
        neighbor=cfg["neighbor"], max_lag=cfg["max_lag"], rung_pick=True,
    )


def _assert_same_blocks(comp, sizes, comp_ref, sizes_ref):
    np.testing.assert_array_equal(sizes, sizes_ref)
    for i, n in enumerate(sizes_ref):
        assert comp[i, :n].tobytes() == comp_ref[i, :n].tobytes(), f"block {i}"


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("block_size", [256, 1024, 4096])
def test_torch_match_matches_lane_model(block_size, config):
    cfg = CONFIGS[config]
    blocks, lens = _inputs(block_size, block_size + len(config))
    mlen, mlag = hopper_match.match_blocks_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **cfg)
    assert mlen.dtype == torch.uint8 and mlag.dtype == torch.int16
    want_len, want_lag = _spec_match(blocks, lens, cfg)
    np.testing.assert_array_equal(mlen.numpy().astype(np.int32), want_len.T)
    np.testing.assert_array_equal(mlag.numpy().astype(np.int32), want_lag.T)
    assert (want_len > 0).sum() > len(lens) * 4  # the inputs do have matches


def test_torch_match_honours_max_lag():
    # A lone 32-byte repeat at lag 129: found with no cap, dropped at 128.
    blocks, lens = streams.hand_plain_blocks(1024, 3, far_lag=129)
    far = 4  # the far-repeat block
    args = torch.from_numpy(blocks[far : far + 1]), torch.from_numpy(lens[far : far + 1])
    mlen, mlag = hopper_match.match_blocks_torch(*args, **{**MAIN, "max_lag": 0})
    assert int(mlen[0, 10 + 129]) >= 32 and int(mlag[0, 10 + 129]) == 129
    mlen, mlag = hopper_match.match_blocks_torch(*args, **{**MAIN, "max_lag": 128})
    assert int(mlen[0, 10 + 129]) == 0


@pytest.mark.parametrize("block_size", [256, 1024, 4096])
def test_torch_emit_matches_lane_model(block_size):
    blocks, lens = _inputs(block_size, 7 * block_size)
    cap = pipeline.padded_capacity(block_size)
    best_len, best_off = _spec_match(blocks, lens, MAIN)
    deferred = lme.lazy_defer(best_len)
    accept, is_copy = lme.greedy_parse(deferred, lens)
    comp_ref, sizes_ref = lme.layout_and_emit(
        blocks.T.astype(np.int32), lens, accept, is_copy, deferred, best_off, cap
    )
    comp, sizes = hopper_encode.emit_blocks_torch(
        torch.from_numpy(blocks), torch.from_numpy(lens),
        torch.from_numpy(best_len.T.astype(np.uint8)), torch.from_numpy(best_off.T.astype(np.int16)), cap,
    )
    assert comp.shape == (len(lens), cap) and sizes.dtype == torch.int32
    _assert_same_blocks(comp.numpy(), sizes.numpy(), comp_ref.T, sizes_ref)
    # Past each size the row is zero.
    assert not (comp.numpy() * (np.arange(cap)[None, :] >= sizes.numpy()[:, None])).any()


@pytest.mark.parametrize("block_size", [256, 1024, 4096, 24576])
def test_torch_encode_matches_encode_lanes(block_size):
    n = 3 if block_size > 4096 else 16
    blocks, lens = _inputs(block_size, 11 * block_size, n)
    cap = pipeline.padded_capacity(block_size)
    comp, sizes = hopper_encode.encode_blocks(torch.from_numpy(blocks), torch.from_numpy(lens), cap=cap, **MAIN)
    comp_ref, sizes_ref = lme.encode_lanes(
        blocks, lens, block_size, cap, matcher="sorted", rung_pick=True, **MAIN
    )
    _assert_same_blocks(comp.numpy(), sizes.numpy(), comp_ref, sizes_ref)
    for i in range(len(lens)):  # and every block decodes to its input
        framed = encode_varint32(int(lens[i])) + encode_varint32(block_size)
        framed += int(sizes[i]).to_bytes(4, "little") + comp[i, : sizes[i]].numpy().tobytes()
        assert oracle.decompress(framed) == blocks[i, : lens[i]].tobytes()


def test_torch_encode_matches_pallas_interpret():
    # The JAX function itself, as tests/test_pallas_encode.py runs it on the
    # CPU: one 128-block group at bs 1024 with the main path's knobs.
    import jax.numpy as jnp

    bs = 1024
    blocks, lens = _inputs(bs, 2024, pallas_encode.LANES - 9)
    comp_k, sizes_k = pallas_encode.encode_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(lens), block_size=bs, matcher="sorted",
        prev_k=1, rung_pick=True, interpret=True, **MAIN,
    )
    comp, sizes = hopper_encode.encode_blocks(
        torch.from_numpy(blocks), torch.from_numpy(lens), cap=pipeline.padded_capacity(bs), **MAIN
    )
    _assert_same_blocks(comp.numpy(), sizes.numpy(), np.asarray(comp_k), np.asarray(sizes_k))


# ---------------------------------------------------------------------------
# The select ladder and 64 KB blocks.
# ---------------------------------------------------------------------------

# The zero-flag config at 64 KB after the reference's switch to the ladder
# (runtime/api.py:372-383), and each preset's 64 KB row.
WIDE = dict(rungs=(4, 16), ext_cap=48, neighbor=True, max_lag=0, sel_cap=16, sel_all=True)
WIDE_CONFIGS = {
    "zero-flag": WIDE,
    **{p: dict(preset_overrides(p, 65536), ext_cap=48, neighbor=True) for p in ("speed", "balanced", "ratio")},
}


def _wide_inputs(block_size: int, seed: int):
    """A text block, a block whose second part repeats its first at lag
    9/16 of the block, and a partial block of zeros."""
    text = np.frombuffer(streams.text_payload(block_size, seed), np.uint8)
    far = np.frombuffer(streams.far_repeat_block(block_size, seed), np.uint8)
    blocks = np.stack([text, far, np.zeros(block_size, np.uint8)])
    return blocks, np.array([block_size, block_size, block_size - 999], np.int32)


def _ladder_knobs(cfg):
    return {k: v for k, v in cfg.items() if k not in ("sweep_span",)}


@pytest.mark.parametrize(
    "block_size, config", [(65536, c) for c in WIDE_CONFIGS] + [(40960, "zero-flag")],
    ids=[f"65536-{c}" for c in WIDE_CONFIGS] + ["40960-zero-flag"],
)
def test_torch_match_64k_matches_lane_model(block_size, config):
    knobs = _ladder_knobs(WIDE_CONFIGS[config])
    blocks, lens = _wide_inputs(block_size, 31)
    mlen, mlag = hopper_match.match_blocks_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
    # The spec at the 65536-row sort the Pallas path pads to (pallas_encode.py:1401-1423).
    padded = np.zeros((len(lens), 65536), np.uint8)
    padded[:, :block_size] = blocks
    want_len, want_lag = lme.match_search_sorted(padded.T.astype(np.int32), lens, **knobs)
    np.testing.assert_array_equal(mlen.numpy().astype(np.int32), want_len.T[:, :block_size])
    np.testing.assert_array_equal(mlag.numpy().astype(np.int64) & 0xFFFF, want_lag.T[:, :block_size])
    assert int(want_lag.max()) > 32768 or knobs["max_lag"]  # lags past int16 reach the output


@pytest.mark.parametrize("block_size", [256, 1024])
def test_torch_encode_ladder_matches_pallas_wide_interpret(block_size):
    # The TPU's select-then-extend, prev-step and wide emit kernels, forced
    # onto the wide path at small sizes, as test_pallas_encode_wide_emit_parity
    # runs them: one 128-block group with the 64 KB presets' ladder.
    import jax.numpy as jnp

    knobs = dict(rungs=(4,), prev_k=2, sel_cap=16, sel_all=True, ext_cap=48, neighbor=True, max_lag=0)
    blocks, lens = _inputs(block_size, 3 * block_size, pallas_encode.LANES - 9)
    comp_k, sizes_k = pallas_encode.encode_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(lens), block_size=block_size, matcher="sorted",
        wide=True, interpret=True, **knobs,
    )
    comp, sizes = hopper_encode.encode_blocks_torch(
        torch.from_numpy(blocks), torch.from_numpy(lens), cap=pipeline.padded_capacity(block_size), **knobs
    )
    _assert_same_blocks(comp.numpy(), sizes.numpy(), np.asarray(comp_k), np.asarray(sizes_k))


@pytest.mark.parametrize("config", list(WIDE_CONFIGS))
def test_torch_encode_64k_matches_encode_lanes(config):
    blocks, lens = _wide_inputs(65536, 32)
    knobs = _ladder_knobs(WIDE_CONFIGS[config])
    cap = pipeline.padded_capacity(65536)
    comp, sizes = hopper_encode.encode_blocks(torch.from_numpy(blocks), torch.from_numpy(lens), cap=cap, **knobs)
    comp_ref, sizes_ref = lme.encode_lanes(blocks, lens, 65536, cap, matcher="sorted", **knobs)
    _assert_same_blocks(comp.numpy(), sizes.numpy(), comp_ref, sizes_ref)
    for i in range(len(lens)):
        framed = encode_varint32(int(lens[i])) + encode_varint32(65536)
        framed += int(sizes[i]).to_bytes(4, "little") + comp[i, : sizes[i]].numpy().tobytes()
        assert oracle.decompress(framed) == blocks[i, : lens[i]].tobytes()


def test_cpu_wrappers_take_the_plain_versions():
    blocks, lens = _inputs(256, 5, 4)
    args = torch.from_numpy(blocks), torch.from_numpy(lens)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    mlen, mlag = hopper_match.match_blocks(*args, **MAIN)
    want = hopper_match.match_blocks_torch(*args, **MAIN)
    assert torch.equal(mlen, want[0]) and torch.equal(mlag, want[1])
    comp, sizes = hopper_encode.emit_blocks(*args, mlen, mlag, 512)
    want = hopper_encode.emit_blocks_torch(*args, mlen, mlag, 512)
    assert torch.equal(comp, want[0]) and torch.equal(sizes, want[1])
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == launches


@pytest.mark.parametrize(
    "knobs",
    [dict(rungs=(16, 4)), dict(rungs=(4, 12)), dict(rungs=()), dict(ext_cap=50), dict(ext_cap=68), dict(max_lag=-1)],
    ids=["descending", "not-a-rung", "no-rungs", "ext-cap-50", "ext-cap-68", "negative-lag"],
)
def test_match_rejects_bad_knobs(knobs):
    blocks, lens = _inputs(256, 1, 1)
    with pytest.raises(ValueError):
        hopper_match.match_blocks(torch.from_numpy(blocks), torch.from_numpy(lens), **{**MAIN, **knobs})


def test_wrappers_reject_bad_tensors():
    blocks = torch.zeros((2, 256), dtype=torch.uint8)
    lens = torch.full((2,), 256, dtype=torch.int32)
    mlen = torch.zeros((2, 256), dtype=torch.uint8)
    mlag = torch.zeros((2, 256), dtype=torch.int16)
    with pytest.raises(ValueError):  # lens of the wrong type
        hopper_match.match_blocks(blocks, lens.long())
    with pytest.raises(ValueError):  # blocks larger than the format's 64 KB
        hopper_match.match_blocks(torch.zeros((1, 65537), dtype=torch.uint8), lens[:1])
    with pytest.raises(ValueError):  # mlag of the wrong type
        hopper_encode.emit_blocks(blocks, lens, mlen, mlag.int(), 512)
    with pytest.raises(ValueError):  # mlen of the wrong shape
        hopper_encode.emit_blocks(blocks, lens, mlen[:, :128], mlag, 512)
