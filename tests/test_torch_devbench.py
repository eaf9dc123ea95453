"""The port's device-resident slope measure against the JAX package's.

``runtime.devbench.slope_measure`` on the ``torch`` engine on the CPU (the
plain PyTorch match, emit and decode) at bs 256: it returns the keys of the
reference's ``pim_compression_tpu.runtime.devbench.slope_measure``, its
encode ratio is the NumPy spec's on the same 1024 blocks, and a corrupt
block makes it raise. Its times here are the CPU's; the card's run is in
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 16.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu.runtime import pipeline as ref_pipeline
from pim_compression_tpu_torch import TorchCodecConfig
from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match
from pim_compression_tpu_torch.runtime import devbench, pipeline
from pim_compression_tpu_torch.utils import streams
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

BS = 256
# The reference's result keys (pim_compression_tpu/runtime/devbench.py:93-133).
SLOPE_KEYS = {"t_g1_s", "t_g8_s", "per_group_s", "device_gbps", "compile_s"}


def _cfg(**kw) -> TorchCodecConfig:
    return TorchCodecConfig(engine="torch", device="cpu", block_size=BS, **kw)


@pytest.fixture(scope="module")
def plain() -> bytes:
    # 300 blocks' worth: slope_measure repeats it to 1024 blocks.
    return streams.text_payload(300 * BS + 77, 41)


def _spec_ratio(plain: bytes, cfg: TorchCodecConfig) -> float:
    """1 - sum(sizes) / (bs * 1024) with the sizes encode_lanes gives the
    same 1024 blocks at the knobs the runtime hands the sorted matcher."""
    need = BS * 1024
    data = (plain * -(-need // len(plain)))[:need]
    blocks, lens = ref_pipeline.blockize_plain(data, BS, 1024)
    cap = pipeline.padded_capacity(BS)
    _, sizes = lme.encode_lanes(
        blocks, lens, BS, cap, matcher="sorted", rungs=cfg.rungs, prev_k=cfg.prev_k,
        stride2_min=cfg.stride2_min, sel_cap=cfg.sel_cap, sel_all=cfg.sel_all, rung_strides=cfg.rung_strides,
        ext_cap=cfg.ext_cap, neighbor=cfg.neighbor, sort_window=cfg.sort_window,
        rung_pick=cfg.effective_rung_pick and not cfg.sel_cap, max_lag=cfg.effective_max_lag,
    )
    return round(1.0 - float(np.asarray(sizes).sum()) / need, 4)


@pytest.mark.parametrize("knobs", [{}, dict(rungs=(4, 8, 16), prev_k=3, sel_cap=8)], ids=["zero-flag", "ladder"])
def test_slope_measure_keys_and_ratio(plain, knobs):
    cfg = _cfg(**knobs)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES
    res = devbench.slope_measure(plain, cfg, iters=1)
    assert set(res) == {"bs", "device", "encode", "decode"}
    assert res["bs"] == BS and res["device"] == "cpu"
    assert set(res["encode"]) == SLOPE_KEYS | {"ratio"} and set(res["decode"]) == SLOPE_KEYS
    for side in ("encode", "decode"):
        r = res[side]
        assert r["t_g1_s"] > 0 and r["t_g8_s"] > 0 and r["compile_s"] > 0
        assert r["per_group_s"] == pytest.approx((r["t_g8_s"] - r["t_g1_s"]) / 7)
        if r["per_group_s"] > 0:
            assert r["device_gbps"] == pytest.approx(BS * 128 / r["per_group_s"] / 1e9)
        else:
            assert r["device_gbps"] is None
    assert res["encode"]["ratio"] == _spec_ratio(plain, cfg)
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES) == launches


def test_a_corrupt_block_raises(plain, monkeypatch):
    compress = devbench.native.compress

    def corrupt(data, block_size):
        stream = bytearray(compress(data, block_size))
        info = pipeline.scan_frames(bytes(stream))
        stream[int(info["payload_off"][1])] = 0x01  # block 1 opens with a copy: nothing to copy from
        return bytes(stream)

    monkeypatch.setattr(devbench.native, "compress", corrupt)
    with pytest.raises(RuntimeError, match="flagged errors"):
        devbench.slope_measure(plain, _cfg(), iters=1)


def test_only_the_device_engines_are_measured(plain, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cfg in (TorchCodecConfig(engine="native"), TorchCodecConfig(engine="cuda", block_size=BS)):
        with pytest.raises(SnappyError) as e:
            devbench.slope_measure(plain, cfg)
        assert e.value.status == SnappyStatus.BAD_ARGUMENT
    with pytest.raises(SnappyError):  # outside the encoder's envelope
        devbench.slope_measure(plain, TorchCodecConfig(engine="torch", device="cpu", block_size=1000))
