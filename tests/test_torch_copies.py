"""The port's own copies of the JAX package's JAX-free modules, held against
the originals: the config (fields, defaults, checks, presets), the typed
errors, the oracle codec and the native host codec.

The port imports nothing of ``pim_compression_tpu``; these tests are where
the two meet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from pim_compression_tpu import native as ref_native
from pim_compression_tpu.format import constants as ref_constants
from pim_compression_tpu.format import oracle as ref_oracle
from pim_compression_tpu.format import varint as ref_varint
from pim_compression_tpu.utils import config as ref_config
from pim_compression_tpu.utils import errors as ref_errors
from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.format import constants, oracle, varint
from pim_compression_tpu_torch.utils import config, errors
from pim_compression_tpu_torch.utils import streams

PORT_ONLY = {"engine", "device"}  # the port's engines and its device


def test_config_fields_and_defaults_match():
    ref = {f.name: f.default for f in dataclasses.fields(ref_config.CodecConfig)}
    port = {f.name: f.default for f in dataclasses.fields(config.TorchCodecConfig)}
    assert set(port) - set(ref) == {"device"} and set(ref) <= set(port)
    for name, default in ref.items():
        if name not in PORT_ONLY:
            assert port[name] == default, name
    assert ref["engine"] == "xla" and port["engine"] == "cuda"
    for prop in ("effective_max_lag", "effective_rung_pick"):
        assert isinstance(getattr(config.TorchCodecConfig, prop), property)


# Every check of CodecConfig.__post_init__, each on one side of its edge.
CONFIG_CASES = [
    dict(block_size=0), dict(block_size=65537), dict(block_size=65536), dict(coarse_mode="bogus"),
    dict(coarse_mode="granular"), dict(matcher="bogus"), dict(matcher="sweep"), dict(sort_window=1000),
    dict(sort_window=256), dict(sort_window=512), dict(rungs=()), dict(rungs=(5,)), dict(rungs=(16, 4)),
    dict(rungs=(4, 4)), dict(rungs=None), dict(prev_k=0), dict(prev_k=9), dict(prev_k=8), dict(stride2_min=4),
    dict(stride2_min=12), dict(stride2_min=8), dict(sel_cap=3), dict(sel_cap=68), dict(sel_all=True),
    dict(sel_all=True, sel_cap=16), dict(rung_strides=(1,)), dict(rung_strides=(1, 3)), dict(rung_strides=(2, 1)),
    dict(rung_strides=(1, 8)), dict(ext_cap=50), dict(ext_cap=0), dict(ext_cap=68), dict(sel_cap=32, ext_cap=16),
    dict(max_lag=-2), dict(max_lag=-1), dict(sweep_span=3), dict(sweep_span=1), dict(sweep_span=64),
    dict(sweep_span=32),
]


@pytest.mark.parametrize("knobs", CONFIG_CASES, ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_config_checks_match(knobs):
    def verdict(cls):
        try:
            cfg = cls(engine="native", **knobs)
        except ValueError as e:
            return "raises", str(e)
        return "ok", (cfg.effective_max_lag, cfg.effective_rung_pick)

    assert verdict(config.TorchCodecConfig) == verdict(ref_config.CodecConfig)


def test_config_refuses_reference_engines():
    for engine in ("xla", "pallas"):
        with pytest.raises(ValueError, match="unknown engine"):
            config.TorchCodecConfig(engine=engine)


@pytest.mark.parametrize("preset", sorted(ref_config.OPERATING_POINTS))
def test_preset_overrides_match(preset):
    assert config.OPERATING_POINTS[preset] == ref_config.OPERATING_POINTS[preset]
    for bs in (256, 4096, 8192, 12288, 16384, 24576, 32768, 49152, 65536):
        assert config.preset_overrides(preset, bs) == ref_config.preset_overrides(preset, bs)


def test_errors_and_constants_match():
    assert {s.name: int(s) for s in errors.SnappyStatus} == {s.name: int(s) for s in ref_errors.SnappyStatus}
    e = errors.SnappyError(errors.SnappyStatus.BAD_ARGUMENT)
    assert isinstance(e, ValueError) and str(e) == str(ref_errors.SnappyError(ref_errors.SnappyStatus.BAD_ARGUMENT))
    for name in ("DEFAULT_BLOCK_SIZE", "MAX_BLOCK_SIZE", "BLOCK_FRAME_BYTES", "HASH_MULTIPLIER"):
        assert getattr(constants, name) == getattr(ref_constants, name)
    for n in (0, 1, 1000, 65536, 10**6):
        assert constants.max_compressed_length(n) == ref_constants.max_compressed_length(n)
    for v in (0, 127, 128, 300, 65536, 0xFFFFFFFF):
        assert varint.encode_varint32(v) == ref_varint.encode_varint32(v)


@pytest.mark.parametrize("block_size", [256, 1024, 4096, 32768, 65536])
def test_oracle_matches(block_size):
    rng = np.random.default_rng(block_size)
    data = streams.text_payload(3 * block_size + 77, block_size) + rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    stream = oracle.compress(data, block_size)
    assert stream == ref_oracle.compress(data, block_size)
    assert oracle.decompress(stream) == ref_oracle.decompress(stream) == data
    assert oracle.scan_block_frames(stream) == ref_oracle.scan_block_frames(stream)
    for cut in (5, len(stream) // 2):  # a truncated stream, and one cut mid-way

        def verdict(codec):
            try:
                return "ok", codec.decompress(stream[:-cut])
            except ValueError as e:
                return "raises", str(e)

        assert verdict(oracle) == verdict(ref_oracle)


@pytest.mark.parametrize("block_size", [1024, 32768, 65536])
def test_native_matches(block_size):
    if not (native.available() and ref_native.available()):
        pytest.skip("a native host codec did not build")
    assert native.library_path().parent == native.BUILD_DIR
    data = streams.text_payload(5 * block_size + 333, block_size + 1)
    stream = native.compress(data, block_size, num_threads=2)
    assert stream == ref_native.compress(data, block_size, num_threads=2) == ref_oracle.compress(data, block_size)
    assert native.decompress(stream) == ref_native.decompress(stream) == data
    got, want = native.scan_frames(stream), ref_native.scan_frames(stream)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(errors.SnappyError) as e:
        native.decompress(stream[:-5])
    with pytest.raises(ref_errors.SnappyError) as ref_e:
        ref_native.decompress(stream[:-5])
    assert int(e.value.status) == int(ref_e.value.status)
