"""The port's block decode against the JAX package's decode.

The plain PyTorch decode (``decode_blocks_torch``) is held against the NumPy
spec ``lane_model.decode_lanes`` and against the Pallas kernels in interpret
mode, exactly: the codec is integer-only, so error bits and each block's
first ``out_len`` bytes must be equal. Inputs are generated from seeds. The
CUDA kernel's tests are in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from pim_compression_tpu.format import oracle
from pim_compression_tpu.ops import lane_model, pallas_decode
from pim_compression_tpu_torch.ops import hopper_decode
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams


def _mixed_payload(seed: int) -> bytes:
    r = random.Random(seed)
    return (
        b"hello world " * 60
        + b"a" * 700
        + r.randbytes(500)
        + b"ab" * 400
        + streams.text_payload(6000, seed)
        + r.randbytes(65)
    )


def _slots(blocks, block_size: int):
    """(payload, out_len) pairs -> comp uint8[n, cap], comp_len, out_len (numpy)."""
    cap = pipeline.padded_capacity(block_size)
    comp = np.zeros((len(blocks), cap), np.uint8)
    clen = np.zeros(len(blocks), np.int32)
    olen = np.zeros(len(blocks), np.int32)
    for i, (payload, out_len) in enumerate(blocks):
        comp[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        clen[i], olen[i] = len(payload), out_len
    return comp, clen, olen


def _stream_blocks(stream: bytes):
    info = pipeline.scan_frames(stream)
    return [
        (stream[o : o + s], int(n))
        for o, s, n in zip(info["payload_off"], info["payload_size"], info["out_size"])
    ]


def _torch_decode(comp, clen, olen, block_size):
    out, err = hopper_decode.decode_blocks_torch(
        torch.from_numpy(comp), torch.from_numpy(clen), torch.from_numpy(olen), block_size
    )
    return out.numpy(), err.numpy()


def _assert_same(got, want, olen):
    (out_g, err_g), (out_w, err_w) = got, want
    np.testing.assert_array_equal(err_g, err_w)
    for i, n in enumerate(olen):
        assert out_g[i, :n].tobytes() == out_w[i, :n].tobytes(), f"block {i}"


# ---------------------------------------------------------------------------
# Plain PyTorch decode against the NumPy spec.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_size", [256, 1024, 4096])
def test_torch_decode_matches_lane_model(block_size):
    data = _mixed_payload(block_size)
    stream = oracle.compress(data, block_size)
    comp, clen, olen = _slots(_stream_blocks(stream), block_size)
    got = _torch_decode(comp, clen, olen, block_size)
    _assert_same(got, lane_model.decode_lanes(comp, clen, olen, block_size), olen)
    assert not got[1].any()
    assert b"".join(got[0][i, :n].tobytes() for i, n in enumerate(olen)) == data


def test_torch_decode_copy4_and_bad_offset():
    # The spec's own cases (test_pallas_decode.py): a COPY_4 element, and a
    # COPY_1 with offset 0.
    copy4 = bytes([4 << 2]) + b"ABCDE" + bytes([3 | (2 << 2), 5, 0, 0, 0])
    bad = bytes([0x00, ord("A"), 0x01, 0x00])
    for block_size in (256, 8192):
        comp, clen, olen = _slots([(copy4, 8), (bad, 5)], block_size)
        got = _torch_decode(comp, clen, olen, block_size)
        _assert_same(got, lane_model.decode_lanes(comp, clen, olen, block_size), olen)
        out, err = got
        assert err[0] == 0 and out[0, :8].tobytes() == b"ABCDEABC"
        assert err[1] & hopper_decode.ERR_BAD_OFFSET


@pytest.mark.parametrize("block_size", [256, 4096])
def test_torch_decode_hand_built_blocks(block_size):
    blocks = streams.hand_blocks(block_size)
    comp, clen, olen = _slots(blocks, block_size)
    got = _torch_decode(comp, clen, olen, block_size)
    _assert_same(got, lane_model.decode_lanes(comp, clen, olen, block_size), olen)
    for i, (payload, n) in enumerate(blocks):
        want = oracle.decompress(streams.frame_block(payload, n, block_size))
        assert got[0][i, :n].tobytes() == want
    # Bytes past out_len are zero, as in the spec.
    assert not got[0][0, olen[0] :].any()


def test_torch_decode_matches_pallas_interpret():
    # The JAX kernels themselves (K1 + K2, interpret mode), on one 128-block
    # group at bs 256.
    bs = 256
    stream = oracle.compress(_mixed_payload(3)[: 100 * bs + 77], bs)
    blocks = _stream_blocks(stream)
    blocks += [(b"", 0)] * (pallas_decode.LANES - len(blocks))
    comp, clen, olen = _slots(blocks, bs)
    assert comp.shape[1] == pallas_decode.pallas_capacity(bs)
    out_p, err_p = pallas_decode.decode_blocks_pallas(comp, clen, olen, block_size=bs, interpret=True)
    got = _torch_decode(comp, clen, olen, bs)
    _assert_same(got, (np.asarray(out_p), np.asarray(err_p)), olen)
    assert not got[1].any()


@pytest.mark.parametrize("block_size", [256, 4096])
def test_torch_decode_malformed_verdicts(block_size):
    # 48 malformed mutants of synthetic blocks: the error bits equal the
    # spec's, and the verdict (err != 0) equals oracle.decompress's.
    stream = oracle.compress(streams.text_payload(3 * block_size, block_size), block_size)
    base = streams.hand_blocks(block_size) + _stream_blocks(stream)
    mutants = streams.block_mutants(base, random.Random(block_size), 48, block_size)
    comp, clen, olen = _slots(mutants, block_size)
    got = _torch_decode(comp, clen, olen, block_size)
    _assert_same(got, lane_model.decode_lanes(comp, clen, olen, block_size), olen)
    for (payload, n), err in zip(mutants, got[1]):
        try:
            oracle.decompress(streams.frame_block(payload, n, block_size))
            oracle_ok = True
        except ValueError:
            oracle_ok = False
        assert (err == 0) == oracle_ok
    assert (got[1] != 0).sum() >= 24  # the set is mostly malformed


# ---------------------------------------------------------------------------
# 64 KB blocks (the TPU's wide path).
# ---------------------------------------------------------------------------


def _wide_payload(seed: int) -> bytes:
    """Two 64 KB blocks that compress to a few KB (the plain decode's time
    follows the longest payload) and a partial last block; the first block
    repeats 512 random bytes at lag 40000, past 32768."""
    rng = np.random.default_rng(seed)
    far = np.zeros(65536, np.uint8)
    far[:512] = far[40000:40512] = rng.integers(0, 256, 512, dtype=np.uint8)
    return far.tobytes() + streams.text_payload(4096, seed) * 16 + streams.text_payload(9000, seed + 1)


def _max_offset(payload: bytes) -> int:
    offsets = [0]
    for p, kind, _ in streams._elements(payload):
        if kind >= 2:  # COPY_2 and COPY_4: 16 or 32 offset bits
            offsets.append(int.from_bytes(payload[p + 1 : p + 1 + 2 * (kind - 1)], "little"))
    return max(offsets)


@pytest.mark.parametrize("codec", ["oracle", "native"])
def test_torch_decode_64k_streams(codec):
    from pim_compression_tpu import native
    from pim_compression_tpu_torch import TorchCodecConfig, runtime

    if codec == "native" and not native.available():
        pytest.skip("native host codec not built")
    data = _wide_payload(64)
    stream = (oracle if codec == "oracle" else native).compress(data, 65536)
    blocks = _stream_blocks(stream)
    assert len(blocks) == 3 and _max_offset(blocks[0][0]) > 32768
    assert bytes(runtime.decompress(stream, TorchCodecConfig(engine="torch", batch_blocks=2))) == data


def test_torch_decode_64k_blocks_and_verdicts():
    # One batch (the plain decode's time follows the longest payload): the
    # hand-built blocks with a copy at offset 65535, the blocks of an oracle
    # and a native stream, and mutants of them. Valid blocks decode to the
    # oracle's bytes; every verdict equals oracle.decompress's.
    from pim_compression_tpu import native

    bs = 65536
    data = _wide_payload(65)
    base = streams.hand_blocks(bs)[-2:] + _stream_blocks(oracle.compress(data, bs))
    if native.available():
        base += _stream_blocks(native.compress(data, bs))
    blocks = base + streams.block_mutants(base, random.Random(bs), 16, bs)
    comp, clen, olen = _slots(blocks, bs)
    out, err = _torch_decode(comp, clen, olen, bs)
    for i, (payload, n) in enumerate(blocks):
        try:
            want = oracle.decompress(streams.frame_block(payload, n, bs))
        except ValueError:
            want = None
        assert (err[i] == 0) == (want is not None), f"block {i}"
        if want is not None:
            assert out[i, :n].tobytes() == want, f"block {i}"
    assert not err[: len(base)].any() and (err != 0).sum() >= 8
    assert b"".join(out[i, : base[i][1]].tobytes() for i in range(2, 5)) == data


def test_torch_decode_matches_pallas_wide_interpret():
    # The TPU's wide path (two-plane tokens, _route_kernel_wide) forced on at
    # bs 1024, as test_pallas_decode_wide_token_path runs it: bytes and error
    # bits equal on valid blocks and mutants.
    bs = 1024
    valid = _stream_blocks(oracle.compress(_mixed_payload(5), bs)) + streams.hand_blocks(bs)
    blocks = valid + streams.block_mutants(valid, random.Random(7), 48, bs)
    blocks += [(b"", 0)] * (pallas_decode.LANES - len(blocks))
    comp, clen, olen = _slots(blocks, bs)
    out_p, err_p = pallas_decode.decode_blocks_pallas(comp, clen, olen, block_size=bs, interpret=True, wide=True)
    got = _torch_decode(comp, clen, olen, bs)
    _assert_same(got, (np.asarray(out_p), np.asarray(err_p)), olen)
    assert not got[1][: len(valid)].any() and (got[1] != 0).sum() >= 24


def test_torch_decode_empty_batch_and_blocks():
    comp = torch.zeros((0, 384), dtype=torch.uint8)
    none = torch.zeros(0, dtype=torch.int32)
    out, err = hopper_decode.decode_blocks(comp, none, none, block_size=256)
    assert out.shape == (0, 256) and err.shape == (0,)
    comp, clen, olen = _slots([(b"", 0), (b"", 3)], 256)
    got = _torch_decode(comp, clen, olen, 256)
    _assert_same(got, lane_model.decode_lanes(comp, clen, olen, 256), olen)
    out, err = got
    assert err[0] == 0 and err[1] & hopper_decode.ERR_LENGTH_MISMATCH
    assert not out.any()


def test_torch_decode_out_of_range_comp_len():
    # comp_len below 0 reads nothing; above cap reads only the slot, as in the spec.
    blocks = streams.hand_blocks(256)[:3]
    comp, clen, olen = _slots(blocks, 256)
    clen[0], clen[1] = -5, comp.shape[1] + 100
    got = _torch_decode(comp, clen, olen, 256)
    _assert_same(got, lane_model.decode_lanes(comp, clen, olen, 256), olen)
    assert got[1][0] and got[1][1] and not got[1][2]


def test_decode_blocks_cpu_routes_to_plain_version():
    comp, clen, olen = _slots(streams.hand_blocks(256), 256)
    args = tuple(torch.from_numpy(a) for a in (comp, clen, olen))
    launches = hopper_decode.LAUNCHES
    out, err = hopper_decode.decode_blocks(*args, block_size=256)
    ref_out, ref_err = hopper_decode.decode_blocks_torch(*args, 256)
    assert torch.equal(out, ref_out) and torch.equal(err, ref_err)
    assert hopper_decode.LAUNCHES == launches  # no kernel ran


@pytest.mark.parametrize(
    "bad",
    [
        dict(block_size=0),
        dict(block_size=65537),
        dict(comp=torch.zeros((2, 384), dtype=torch.int32)),
        dict(comp_len=torch.zeros(2, dtype=torch.int64)),
        dict(out_len=torch.zeros(3, dtype=torch.int32)),
        dict(out_len=torch.full((2,), 300, dtype=torch.int32)),
    ],
    ids=["bs0", "bs64k", "comp-dtype", "clen-dtype", "olen-shape", "olen-range"],
)
def test_decode_blocks_rejects_bad_inputs(bad):
    args = dict(
        comp=torch.zeros((2, 384), dtype=torch.uint8),
        comp_len=torch.zeros(2, dtype=torch.int32),
        out_len=torch.zeros(2, dtype=torch.int32),
        block_size=256,
    )
    args.update(bad)
    with pytest.raises(ValueError):
        hopper_decode.decode_blocks(
            args["comp"], args["comp_len"], args["out_len"], block_size=args["block_size"]
        )
