"""The port's compress entry point and its host helpers, against the JAX package.

``runtime.compress`` on the ``torch`` engine (the plain PyTorch match and
emit on the CPU) must give the stream the JAX ``runtime.compress`` gives on
its ``pallas`` engine (interpret mode here), byte for byte, and round-trip
through the reference's decoders and the port's own. The host helpers are
held against the reference's ``runtime.pipeline``. The ``cuda`` engine's
round trip is in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from pim_compression_tpu import native
from pim_compression_tpu.format import oracle
from pim_compression_tpu.format.varint import encode_varint32
from pim_compression_tpu.runtime import pipeline as ref_pipeline
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus
from pim_compression_tpu_torch import TorchCodecConfig, runtime
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """Run the host helpers through the native library or the numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(pipeline.native, "available", lambda: False)
    elif not native.available():
        pytest.skip("native host codec not built")
    return request.param


def _payload(num_blocks: int, block_size: int, random_at: tuple[int, ...], seed: int) -> bytes:
    """Text-like blocks with seeded random blocks spliced in at block
    boundaries, and a partial last block."""
    r = random.Random(seed)
    text = streams.text_payload(num_blocks * block_size, seed)
    blocks = [text[i * block_size : (i + 1) * block_size] for i in range(num_blocks)]
    for i in random_at:
        blocks[i] = r.randbytes(block_size)
    return b"".join(blocks) + text[: block_size // 3]


def _torch_cfg(**kw) -> TorchCodecConfig:
    return TorchCodecConfig(engine="torch", **kw)


# ---------------------------------------------------------------------------
# Host helpers against the reference pipeline.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 1024, 5 * 1024 + 77])
def test_blockize_plain_zeroes_past_lens(host_path, size):
    data = streams.text_payload(size, size)
    # A stale staging buffer must not leak into the slots: fill one first.
    pipeline.blockize_plain(b"\xff" * 8 * 1024, 1024)
    blocks, lens = pipeline.blockize_plain(data, 1024)
    nb = -(-size // 1024)
    ref_blocks, ref_lens = ref_pipeline.blockize_plain(data, 1024, nb)
    np.testing.assert_array_equal(blocks, ref_blocks)
    np.testing.assert_array_equal(lens, ref_lens)
    assert blocks.reshape(-1)[:size].tobytes() == data
    assert not blocks.reshape(-1)[size:].any()


@pytest.mark.parametrize("num_blocks, block_size", [(24, 1024), (150, 1024)])
def test_triage_diverts_the_reference_blocks(num_blocks, block_size):
    data = _payload(num_blocks, block_size, (3, 4, 17, num_blocks - 1), 8)
    blocks, lens = pipeline.blockize_plain(data, block_size)
    got = pipeline.triage_incompressible(blocks, lens)
    np.testing.assert_array_equal(got, ref_pipeline.triage_incompressible(blocks, lens))
    assert got[[3, 4, 17, num_blocks - 1]].all() and not got[-1]  # the partial last block stays


@pytest.mark.parametrize("block_size", [256, 1024, 65536])
def test_raw_literal_frames_match_the_reference(block_size):
    # Lengths that take 0, 1, 2 and 3 header length bytes, and an empty block.
    rng = np.random.default_rng(block_size)
    lens = np.array([0, 1, 60, 61, 256, 257, block_size], dtype=np.int32)
    lens = np.minimum(lens, block_size)
    blocks = rng.integers(0, 256, (len(lens), block_size), dtype=np.uint8)
    blocks[np.arange(block_size)[None, :] >= lens[:, None]] = 0
    cap = pipeline.padded_capacity(block_size)
    idx = np.array([0, 2, 3, 4, 5, 6])
    comp, sizes = np.zeros((len(lens), cap), np.uint8), np.full(len(lens), -1, np.int32)
    ref_comp, ref_sizes = comp.copy(), sizes.copy()
    pipeline.raw_literal_frames(blocks, lens, comp, sizes, idx)
    ref_pipeline.raw_literal_frames(blocks, lens, ref_comp, ref_sizes, idx)
    np.testing.assert_array_equal(sizes, ref_sizes)
    for i in idx:
        assert comp[i, : sizes[i]].tobytes() == ref_comp[i, : sizes[i]].tobytes()


def test_assemble_compressed_matches_the_reference(host_path):
    rng = np.random.default_rng(4)
    comp = rng.integers(0, 256, (5, 384), dtype=np.uint8)
    sizes = np.array([0, 1, 384, 200, 7], dtype=np.int32)
    got = pipeline.assemble_compressed(comp, sizes, 4 * 256 + 100, 256)
    assert bytes(got) == bytes(ref_pipeline.assemble_compressed(comp, sizes, 4 * 256 + 100, 256, 5))


# ---------------------------------------------------------------------------
# compress on the torch engine.
# ---------------------------------------------------------------------------


def test_torch_compress_equals_jax_pallas_stream():
    # ~100 blocks, two random blocks for the triage, a partial last block:
    # the whole stream (triage, raw frames, encode, assembly) must be equal.
    from pim_compression_tpu import runtime as ref_runtime

    data = _payload(100, 1024, (10, 61), 12)
    ref_timer = ref_runtime.PhaseTimer()
    want = ref_runtime.compress(data, CodecConfig(engine="pallas", block_size=1024), ref_timer)
    timer = runtime.PhaseTimer()
    got = runtime.compress(data, _torch_cfg(block_size=1024), timer)
    assert bytes(got) == bytes(want)
    assert timer.notes["raw_blocks"] == ref_timer.notes["raw_blocks"] >= 2
    assert oracle.decompress(bytes(got)) == data


def test_torch_compress_ladder_equals_jax_pallas_stream():
    # The sel_all ladder with a prev step below 32 KB, where the reference
    # takes it as configured: the same stream as its pallas engine.
    from pim_compression_tpu import runtime as ref_runtime

    knobs = dict(rungs=(4, 32), prev_k=3, sel_cap=12, sel_all=True, max_lag=600)
    data = _payload(40, 1024, (7,), 13)
    ref_timer = ref_runtime.PhaseTimer()
    want = ref_runtime.compress(data, CodecConfig(engine="pallas", block_size=1024, **knobs), ref_timer)
    timer = runtime.PhaseTimer()
    got = runtime.compress(data, _torch_cfg(block_size=1024, **knobs), timer)
    assert bytes(got) == bytes(want)
    assert timer.notes == ref_timer.notes == {"raw_blocks": 1}
    assert oracle.decompress(bytes(got)) == data


@pytest.mark.parametrize(
    "data",
    [b"", b"x", bytes(random.Random(9).randbytes(6 * 1024)), None],
    ids=["empty", "one-byte", "all-random", "text"],
)
def test_torch_compress_round_trip(host_path, data):
    if data is None:
        data = _payload(13, 1024, (5,), 3)
    timer = runtime.PhaseTimer()
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    stream = runtime.compress(data, _torch_cfg(block_size=1024, batch_blocks=4), timer)
    assert oracle.decompress(bytes(stream)) == data
    assert bytes(runtime.decompress(bytes(stream), _torch_cfg())) == data
    if native.available():
        assert native.decompress(bytes(stream)) == data
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == launches  # the CPU runs no kernel
    if len(data) == 6 * 1024:  # every block diverted: no device batch at all
        assert timer.notes["raw_blocks"] == 6 and timer.seconds["kernel"] == 0
        header = len(encode_varint32(len(data)) + encode_varint32(1024))
        assert len(stream) == header + 6 * (4 + 3 + 1024)  # frame, literal tag and 2 length bytes


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("block_size", [1000, 32768])
def test_empty_input_returns_before_any_check(engine, block_size, monkeypatch):
    # The reference returns the header-only stream, and b"" for a stream of
    # no blocks, before it checks the block size or looks for a device
    # (pim_compression_tpu/runtime/api.py:154-160, :280-285). So does the
    # port: at a block size outside its kernels' envelope, and on the cuda
    # engine without a GPU. Non-empty input at that size takes the portable
    # engine on the torch engine's device, with a warning, as the
    # reference's pallas engine takes its xla engine; the cuda engine
    # without a GPU still refuses it.
    from pim_compression_tpu import runtime as ref_runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    want = bytes(ref_runtime.compress(b"", CodecConfig(block_size=block_size)))
    if block_size == 1000:
        assert want == b"\x00\xe8\x07"
    cfg = TorchCodecConfig(engine=engine, block_size=block_size)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    assert bytes(runtime.compress(b"", cfg)) == want
    for dec_engine in ("torch", "cuda", "native", "oracle"):
        assert runtime.decompress(want, TorchCodecConfig(engine=dec_engine)) == b""
    data = b"not empty " * 300
    if engine == "torch" and block_size == 32768:  # on the path: compressed
        assert oracle.decompress(bytes(runtime.compress(data, cfg))) == data
    elif engine == "torch":
        with pytest.warns(UserWarning, match="falling back to the portable engine"):
            assert oracle.decompress(bytes(runtime.compress(data, cfg))) == data
    else:
        with pytest.raises(SnappyError) as e:
            runtime.compress(data, cfg)
        assert e.value.status == SnappyStatus.BAD_ARGUMENT
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == launches


def test_torch_compress_verify_and_batches_agree():
    data = _payload(9, 512, (2,), 21)
    one = runtime.compress(data, _torch_cfg(block_size=512))
    batched = runtime.compress(data, _torch_cfg(block_size=512, batch_blocks=3, verify=True))
    assert bytes(one) == bytes(batched)


def test_verify_catches_a_bad_encoder(monkeypatch):
    encode = hopper_encode.encode_blocks_torch

    def corrupt(blocks, lens, **kw):
        comp, sizes = encode(blocks, lens, **kw)
        comp[1, 0] ^= 0x04  # block 1's first tag now claims one more byte
        return comp, sizes

    monkeypatch.setattr(hopper_encode, "encode_blocks_torch", corrupt)
    data = _payload(4, 256, (), 5)
    with pytest.raises(SnappyError) as e:
        runtime.compress(data, _torch_cfg(block_size=256, verify=True))
    assert e.value.status == SnappyStatus.INVALID_INPUT and "[1]" in str(e.value)
    runtime.compress(data, _torch_cfg(block_size=256))  # unverified, it passes


@pytest.mark.parametrize(
    "knobs", [{}, dict(rungs=(4,), prev_k=2, sel_cap=0)], ids=["zero-flag", "prev-k-2"]
)
def test_torch_compress_64k_equals_the_spec(knobs):
    # About 2 x 64 KB + 9000 bytes with one seeded random block. Above 32768
    # the reference switches every config to the sel_all ladder with
    # sel_cap 16 (runtime/api.py:372-383, tests/test_runtime.py:177-210);
    # its interpret-mode run at 64 KB is too slow here, so the stream is
    # held against the NumPy spec's blocks with the random block raw.
    from pim_compression_tpu.ops import lane_model_encode as lme

    bs = 65536
    rng = np.random.default_rng(64)
    # Blocks that compress well keep the plain decode's step count low.
    data = streams.text_payload(bs // 16, 64) * 16 + rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    data += streams.far_repeat_block(bs, 65)[:9000]
    cfg = _torch_cfg(block_size=bs, **knobs)
    timer = runtime.PhaseTimer()
    got = runtime.compress(data, cfg, timer)
    assert timer.notes == {"raw_blocks": 1, "wide_select": "sel_all sel_cap=16"}

    blocks, lens = ref_pipeline.blockize_plain(data, bs, 3)
    raw = ref_pipeline.triage_incompressible(blocks, lens)
    assert raw.tolist() == [False, True, False]
    cap = pipeline.padded_capacity(bs)
    comp, sizes = np.zeros((3, cap), np.uint8), np.zeros(3, np.int32)
    spec = dict(rungs=cfg.rungs, prev_k=cfg.prev_k, sel_cap=16, sel_all=True, ext_cap=48, neighbor=True, max_lag=0)
    comp[~raw], sizes[~raw] = lme.encode_lanes(blocks[~raw], lens[~raw], bs, cap, matcher="sorted", **spec)
    ref_pipeline.raw_literal_frames(blocks, lens, comp, sizes, np.flatnonzero(raw))
    assert bytes(got) == bytes(ref_pipeline.assemble_compressed(comp, sizes, len(data), bs, 3))
    assert oracle.decompress(bytes(got)) == data
    if native.available():
        assert native.decompress(bytes(got)) == data
    if not knobs:  # once: the raw block's payload takes the plain decode 65540 lockstep steps
        assert bytes(runtime.decompress(bytes(got), _torch_cfg())) == data


# ---------------------------------------------------------------------------
# What is off the kernels' path: the envelope falls back to the portable
# engine (or raises under strict_engine); a knob the reference refuses raises.
# ---------------------------------------------------------------------------

# The sorted matcher's sort modes and ladders, ported: refused on the cuda
# engine without a GPU only.
PORTED_KNOBS = {
    "prev-k-2": dict(prev_k=2), "sel-cap": dict(sel_cap=16),
    "sel-all": dict(sel_cap=16, sel_all=True, stride2_min=16), "stride2": dict(stride2_min=16),
    "rung-strides": dict(rung_strides=(1, 2)), "sort-window": dict(sort_window=512),
    "no-rung-pick": dict(rung_pick=False),
}
# Outside the kernels' envelope (hopper_encode.envelope_gap): the reference's
# pallas engine falls back to its xla engine there, the port to portable.
FALLBACK_KNOBS = {
    "bs-65536": dict(block_size=65536, matcher="sweep"), "bs-1000": dict(block_size=1000),
    "bs-128": dict(block_size=128), "sweep": dict(matcher="sweep"),
}
REFUSED_KNOBS = {
    # A window must divide the block's padded sort size, as in the reference.
    "window-past-block": dict(sort_window=65536), "window-past-1024": dict(block_size=1024, sort_window=2048),
    "window-past-24576": dict(block_size=24576, sort_window=65536),
}


def _spec_stream(data: bytes, cfg: TorchCodecConfig) -> bytes:
    """The reference pipeline's stream for a config at a power-of-two block
    size: its triage and raw frames, and the NumPy spec's blocks with the
    knobs its runtime hands the sorted matcher (runtime/api.py:372-405)."""
    from pim_compression_tpu.ops import lane_model_encode as lme

    bs = cfg.block_size
    blocks, lens = ref_pipeline.blockize_plain(data, bs, -(-len(data) // bs))
    raw = ref_pipeline.triage_incompressible(blocks, lens)
    cap = pipeline.padded_capacity(bs)
    comp, sizes = np.zeros((len(lens), cap), np.uint8), np.zeros(len(lens), np.int32)
    comp[~raw], sizes[~raw] = lme.encode_lanes(
        blocks[~raw], lens[~raw], bs, cap, matcher="sorted", rungs=cfg.rungs, prev_k=cfg.prev_k,
        stride2_min=cfg.stride2_min, sel_cap=cfg.sel_cap, sel_all=cfg.sel_all, rung_strides=cfg.rung_strides,
        ext_cap=cfg.ext_cap, neighbor=cfg.neighbor, sort_window=cfg.sort_window,
        rung_pick=cfg.effective_rung_pick and not cfg.sel_cap, max_lag=cfg.effective_max_lag,
    )
    ref_pipeline.raw_literal_frames(blocks, lens, comp, sizes, np.flatnonzero(raw))
    return bytes(ref_pipeline.assemble_compressed(comp, sizes, len(data), bs, len(lens)))


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("knobs", [*PORTED_KNOBS.values(), *FALLBACK_KNOBS.values(), *REFUSED_KNOBS.values()],
                         ids=[*PORTED_KNOBS, *FALLBACK_KNOBS, *REFUSED_KNOBS])
def test_off_path_knobs_raise_bad_argument(engine, knobs, monkeypatch):
    # A knob the reference refuses raises BAD_ARGUMENT before any launch on
    # both engines; the cuda engine raises without a GPU, for want of a
    # device. The torch engine compresses the ported sort modes and ladders
    # to the reference's stream, and outside the envelope falls back to the
    # portable engine with a warning and a note, or raises BAD_ARGUMENT
    # before any launch under strict_engine.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = b"off the ported path " * 100
    cfg = TorchCodecConfig(engine=engine, **knobs)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    if knobs in FALLBACK_KNOBS.values():
        with pytest.raises(SnappyError) as e:
            runtime.compress(data, dataclasses.replace(cfg, strict_engine=True))
        assert e.value.status == SnappyStatus.BAD_ARGUMENT and "falling back" in str(e.value)
    if engine == "torch" and knobs in FALLBACK_KNOBS.values():
        timer = runtime.PhaseTimer()
        with pytest.warns(UserWarning, match="falling back to the portable engine"):
            stream = runtime.compress(data, cfg, timer)
        assert timer.notes["engine_fallback"].startswith("torch->portable (")
        assert oracle.decompress(bytes(stream)) == data
    elif engine == "torch" and knobs in PORTED_KNOBS.values():
        stream = runtime.compress(data, cfg)
        assert bytes(stream) == _spec_stream(data, cfg)
        assert oracle.decompress(bytes(stream)) == data
    else:
        with pytest.raises(SnappyError) as e:
            runtime.compress(data, cfg)
        assert e.value.status == SnappyStatus.BAD_ARGUMENT
        words = ("needs a CUDA device",) if knobs not in REFUSED_KNOBS.values() else ("padded sort size",)
        assert any(w in str(e.value) for w in words), str(e.value)
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == launches


def test_cuda_compress_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SnappyError) as e:
        runtime.compress(b"no gpu here " * 100, TorchCodecConfig(engine="cuda", block_size=1024))
    assert e.value.status == SnappyStatus.BAD_ARGUMENT
    with pytest.raises(SnappyError):  # and never on the CPU
        runtime.compress(b"cpu " * 100, TorchCodecConfig(engine="cuda", device="cpu", block_size=1024))


def test_host_engines_pass_through():
    data = streams.text_payload(5000, 2)
    assert runtime.compress(data, TorchCodecConfig(engine="oracle", block_size=1024)) == oracle.compress(data, 1024)
    if native.available():
        got = runtime.compress(data, TorchCodecConfig(engine="native", block_size=1024))
        assert got == native.compress(data, 1024)
