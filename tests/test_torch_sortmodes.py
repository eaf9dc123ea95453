"""The sorted matcher's sort modes and ladders in the port, against the JAX package.

Strided rung sorts (``stride2_min``, ``rung_strides``), sort windows
(``sort_window``) and the per-rung ladder (``rung_pick=False``, ``prev_k >
1`` or ``sel_cap`` without ``sel_all``), as ``hopper_encode.encode_knobs``
hands them on from a ``TorchCodecConfig``. The plain PyTorch match equals
the NumPy spec ``lane_model_encode.match_search_sorted`` on every position,
run on the block padded to its power-of-two sort size as the Pallas path
runs it, and the encode equals ``encode_lanes`` and decodes back. Exact:
the codec is integer-only. The interpret-mode Pallas cases are in
``test_torch_sortmodes_pallas.py``, the CUDA kernel's in
``test_torch_cuda.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pim_compression_tpu.format import oracle
from pim_compression_tpu.format.varint import encode_varint32
from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu_torch import TorchCodecConfig
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

# The configs of the sort modes, as config fields. (c)'s window is a
# fraction of the block where the block is smaller than 8192 bytes' groups
# allow: a window must divide the padded sort size.
CONFIGS = {
    "a-full-ladder-prev4-sel16-stride2": dict(rungs=None, prev_k=4, sel_cap=16, stride2_min=16),
    "b-ladder-prev6": dict(rungs=(4, 16), rung_pick=False, prev_k=6),
    "c-windowed-rung-pick": dict(rungs=(4, 16), sort_window=8192),
    "d-sel-all-strides-1-8": dict(rungs=(4, 32), prev_k=2, sel_cap=16, sel_all=True, rung_strides=(1, 8)),
    "full-rung-pick-strides-1-2-4-8-8": dict(rungs=None, rung_strides=(1, 2, 4, 8, 8)),
    "window-512-strides": dict(rungs=(4, 16, 64), rung_strides=(1, 2, 4), sort_window=512),
    "window-2048-ladder-strides": dict(rungs=(4, 8, 32), rung_strides=(1, 2, 8), prev_k=3, sel_cap=8,
                                       sort_window=2048),
}


def _config(name: str, block_size: int, **extra) -> TorchCodecConfig:
    fields = dict(CONFIGS[name], **extra)
    window = fields.get("sort_window", 0)
    if window > hopper_match.sort_size(block_size) // 2:
        fields["sort_window"] = max(512, hopper_match.sort_size(block_size) // 2)
    return TorchCodecConfig(engine="torch", block_size=block_size, **fields)


def _spec_knobs(cfg) -> dict:
    """The knobs the reference's runtime hands its sorted matcher
    (runtime/api.py:372-405), in the spec's names."""
    sel_cap, sel_all = cfg.sel_cap, cfg.sel_all
    if cfg.block_size > 32768 and not (sel_all and sel_cap):
        sel_cap, sel_all = sel_cap or 16, True
    return dict(
        rungs=cfg.rungs or (4, 8, 16, 32, 64), prev_k=cfg.prev_k, stride2_min=cfg.stride2_min,
        sel_cap=sel_cap, sel_all=sel_all, rung_strides=cfg.rung_strides, ext_cap=cfg.ext_cap,
        neighbor=cfg.neighbor, sort_window=cfg.sort_window,
        rung_pick=cfg.effective_rung_pick and not sel_cap, max_lag=cfg.effective_max_lag,
    )


def _spec_match(blocks, lens, cfg):
    """match_search_sorted on the blocks padded to the sort size; (len, lag)
    as [nb, bs]."""
    bs = blocks.shape[1]
    padded = np.zeros((len(lens), hopper_match.sort_size(bs)), np.uint8)
    padded[:, :bs] = blocks
    best_len, best_off = lme.match_search_sorted(padded.T.astype(np.int32), lens, **_spec_knobs(cfg))
    return best_len.T[:, :bs], best_off.T[:, :bs]


def _inputs(block_size: int, seed: int, num_random: int):
    rb, rl = streams.plain_blocks(block_size, num_random, seed)
    hb, hl = streams.hand_plain_blocks(block_size, seed, far_lag=129)
    return np.concatenate([rb, hb]), np.concatenate([rl, hl])


def _assert_match_equal(blocks, lens, cfg):
    knobs = hopper_encode.encode_knobs(cfg)
    mlen, mlag = hopper_match.match_blocks_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
    want_len, want_lag = _spec_match(blocks, lens, cfg)
    np.testing.assert_array_equal(mlen.numpy().astype(np.int32), want_len)
    np.testing.assert_array_equal(mlag.numpy().astype(np.int64) & 0xFFFF, want_lag)
    assert (want_len > 0).sum() > len(lens) * 4  # the inputs do have matches


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("block_size", [1024, 4096, 24576])
def test_torch_match_sort_modes_match_lane_model(block_size, config):
    blocks, lens = _inputs(block_size, block_size + len(config), 3 if block_size > 4096 else 12)
    _assert_match_equal(blocks, lens, _config(config, block_size))


def test_torch_match_64k_strided_window_matches_lane_model():
    # Config (e): above 32768 the reference switches to the sel_all ladder;
    # the stride-2 rung sorts 32768 rows (17-bit keys) and the window
    # groups of 16384 and 8192 rows.
    bs = 65536
    text = np.frombuffer(streams.text_payload(bs, 41), np.uint8)
    far = np.frombuffer(streams.far_repeat_block(bs, 41), np.uint8)
    blocks = np.stack([text, far, np.zeros(bs, np.uint8)])
    lens = np.array([bs, bs, bs - 999], np.int32)
    cfg = TorchCodecConfig(engine="torch", block_size=bs, rungs=(4, 32), rung_strides=(1, 2), sort_window=16384)
    notes = {}
    knobs = hopper_encode.encode_knobs(cfg, notes)
    assert notes == {"wide_select": "sel_all sel_cap=16"} and knobs["sel_all"] and knobs["strides"] == (1, 2)
    _assert_match_equal(blocks, lens, cfg)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("block_size", [1024, 4096])
def test_torch_encode_sort_modes_match_encode_lanes(block_size, config):
    blocks, lens = _inputs(block_size, 3 * block_size + len(config), 6)
    cfg = _config(config, block_size)
    cap = pipeline.padded_capacity(block_size)
    comp, sizes = hopper_encode.encode_blocks_torch(
        torch.from_numpy(blocks), torch.from_numpy(lens), cap=cap, **hopper_encode.encode_knobs(cfg)
    )
    comp_ref, sizes_ref = lme.encode_lanes(blocks, lens, block_size, cap, matcher="sorted", **_spec_knobs(cfg))
    np.testing.assert_array_equal(sizes.numpy(), sizes_ref)
    for i in range(len(lens)):
        assert comp[i, : sizes[i]].numpy().tobytes() == comp_ref[i, : sizes_ref[i]].tobytes(), f"block {i}"
        framed = encode_varint32(int(lens[i])) + encode_varint32(block_size)
        framed += int(sizes[i]).to_bytes(4, "little") + comp[i, : sizes[i]].numpy().tobytes()
        assert oracle.decompress(framed) == blocks[i, : lens[i]].tobytes()
