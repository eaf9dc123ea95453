"""The port's runtime: config, frame scan, decompress entry point, imports.

Round trips use the ``torch`` engine on the CPU and are held against the
plaintext and the reference's host codecs. The ``cuda`` engine's round trip
is in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pim_compression_tpu import native
from pim_compression_tpu.format import oracle
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus
from pim_compression_tpu_torch import TorchCodecConfig, runtime
from pim_compression_tpu_torch.ops import hopper_decode
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

REPO = pathlib.Path(__file__).resolve().parent.parent


def _torch_cfg(**kw) -> TorchCodecConfig:
    return TorchCodecConfig(engine="torch", **kw)


@pytest.fixture(params=["native", "oracle"])
def scan_path(request, monkeypatch):
    """Run the host layer through the native helpers or the numpy fallback."""
    if request.param == "oracle":
        monkeypatch.setattr(pipeline.native, "available", lambda: False)
    elif not native.available():
        pytest.skip("native host codec not built")
    return request.param


# ---------------------------------------------------------------------------
# Config.
# ---------------------------------------------------------------------------


def test_config_defaults_and_engines():
    cfg = TorchCodecConfig()
    assert cfg.engine == "cuda" and cfg.device is None and cfg.batch_blocks == 1024
    for engine in ("cuda", "torch", "native", "oracle"):
        assert TorchCodecConfig(engine=engine).engine == engine
    for engine in ("pallas", "xla", "gpu"):
        with pytest.raises(ValueError):
            TorchCodecConfig(engine=engine)
    with pytest.raises(ValueError):  # the reference's own checks still run
        TorchCodecConfig(block_size=0)
    with pytest.raises(ValueError):
        TorchCodecConfig(sweep_span=3)


@pytest.mark.parametrize(
    "ref_engine, engine", [("pallas", "cuda"), ("xla", None), ("native", "native"), ("oracle", "oracle")]
)
def test_config_from_reference(ref_engine, engine):
    ref = CodecConfig(engine=ref_engine, block_size=8192, batch_blocks=64, validate=False, max_lag=4096)
    if engine is None:  # the xla engine's stream has no port yet
        with pytest.raises(ValueError, match="ROADMAP A item 6"):
            TorchCodecConfig.from_reference(ref, device="cpu")
        return
    cfg = TorchCodecConfig.from_reference(ref, device="cpu")
    assert not isinstance(cfg, CodecConfig)  # the port's own dataclass
    assert cfg.engine == engine and cfg.device == "cpu"
    for field in dataclasses.fields(CodecConfig):
        if field.name != "engine":
            assert getattr(cfg, field.name) == getattr(ref, field.name), field.name


# ---------------------------------------------------------------------------
# Host layer.
# ---------------------------------------------------------------------------


def test_scan_and_blockize_paths_agree(scan_path):
    data = streams.text_payload(5 * 1024 + 300, 5)
    stream = oracle.compress(data, 1024)
    info = pipeline.scan_frames(stream)
    assert info["total_len"] == len(data) and info["block_size"] == 1024
    np.testing.assert_array_equal(info["out_size"], [1024] * 5 + [300])
    comp, clen, olen = pipeline.blockize_compressed(stream, info)
    assert comp.shape == (6, pipeline.padded_capacity(1024))
    for i, (off, size) in enumerate(zip(info["payload_off"], info["payload_size"])):
        assert comp[i, :size].tobytes() == stream[off : off + size]
    np.testing.assert_array_equal(olen, info["out_size"])
    np.testing.assert_array_equal(clen, info["payload_size"])


def test_scan_rejects_declared_block_size_163840(scan_path):
    # A stream that declares 163840-byte blocks (the fuzzer's finding): the
    # reference's oracle scan accepts it, the port's scan must not.
    hand = streams.hand_blocks(256)[0]
    stream = streams.frame_block(hand[0], hand[1], 163840)
    with pytest.raises(SnappyError) as e:
        pipeline.scan_frames(stream)
    assert e.value.status == SnappyStatus.INVALID_INPUT
    with pytest.raises(SnappyError):
        runtime.decompress(stream, _torch_cfg())


def test_scan_rejects_missing_frames(scan_path):
    stream = oracle.compress(b"x" * 3000, 1024)
    info = pipeline.scan_frames(stream)
    cut = stream[: int(info["payload_off"][2]) - 4]  # the last frame is gone
    with pytest.raises((SnappyError, ValueError)):
        pipeline.scan_frames(cut)


# ---------------------------------------------------------------------------
# decompress on the torch engine.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "block_size, size",
    [(256, 10 * 256 + 100), (256, 8 * 256), (1024, 3000), (24576, 30000)],
    ids=["tail-batch-partial-block", "whole-batches", "one-batch", "bs24576"],
)
def test_torch_engine_round_trip(scan_path, block_size, size):
    data = streams.text_payload(size, block_size + size)
    stream = oracle.compress(data, block_size)
    timer = runtime.PhaseTimer()
    out = runtime.decompress(stream, _torch_cfg(batch_blocks=4), timer)
    assert bytes(out) == data
    if native.available():
        assert native.decompress(stream) == data
    for phase in ("pre", "h2d", "kernel", "d2h"):
        assert timer.seconds[phase] > 0


def test_torch_engine_empty_payload():
    stream = oracle.compress(b"", 256)
    assert runtime.decompress(stream, _torch_cfg()) == b""
    assert oracle.decompress(stream) == b""


def test_host_engines_pass_through():
    data = streams.text_payload(5000, 9)
    stream = oracle.compress(data, 1024)
    assert runtime.decompress(stream, TorchCodecConfig(engine="oracle")) == data
    if native.available():
        assert runtime.decompress(stream, TorchCodecConfig(engine="native")) == data


def test_validate_names_the_corrupt_block(scan_path):
    data = streams.text_payload(4 * 512, 11)
    stream = bytearray(oracle.compress(data, 512))
    info = pipeline.scan_frames(bytes(stream))
    stream[int(info["payload_off"][2])] = 0x01  # block 2 opens with a copy
    with pytest.raises(SnappyError) as e:
        runtime.decompress(bytes(stream), _torch_cfg(batch_blocks=2))
    assert e.value.status == SnappyStatus.INVALID_INPUT
    assert "block 2 " in str(e.value)
    out = runtime.decompress(bytes(stream), _torch_cfg(validate=False))
    assert len(out) == len(data) and out[:1024] == data[:1024]
    with pytest.raises(ValueError):
        oracle.decompress(bytes(stream))


def test_cuda_engine_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream = oracle.compress(b"no gpu here " * 100, 256)
    launches = hopper_decode.LAUNCHES
    with pytest.raises(SnappyError) as e:
        runtime.decompress(stream, TorchCodecConfig(engine="cuda"))
    assert e.value.status == SnappyStatus.BAD_ARGUMENT
    assert hopper_decode.LAUNCHES == launches


def test_cuda_engine_never_runs_on_the_cpu():
    stream = oracle.compress(b"cpu " * 100, 256)
    with pytest.raises(SnappyError):
        runtime.decompress(stream, TorchCodecConfig(engine="cuda", device="cpu"))


def test_import_leaves_jax_out():
    # The port and a torch-engine compress and decompress, checked with the
    # port's own oracle, load neither JAX nor any module of the JAX package.
    code = (
        "import sys\n"
        "import pim_compression_tpu_torch as p\n"
        "from pim_compression_tpu_torch.format import oracle\n"
        "data = b'jax-free ' * 500\n"
        "cfg = p.TorchCodecConfig(engine='torch', block_size=256)\n"
        "s = p.runtime.compress(data, cfg)\n"
        "assert oracle.decompress(bytes(s)) == data\n"
        "assert p.runtime.decompress(s, cfg) == data\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'pim_compression_tpu']\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_do_not_import_jax():
    # Neither JAX nor any module of the JAX package: the port carries its own
    # copies of what it needs.
    banned = re.compile(r"^\s*(from|import)\s+(jax|pim_compression_tpu)(\.|\s|$)", re.M)
    for path in [*(REPO / "pim_compression_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not banned.search(path.read_text()), path
