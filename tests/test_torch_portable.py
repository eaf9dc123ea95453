"""The portable engine against the JAX package's ``xla`` engine, on the CPU.

The port's ``ops/primitives.py``, ``ops/decode.py`` and ``ops/encode.py``
(plain PyTorch ops, the ``portable`` engine) are held against
``pim_compression_tpu.ops.{primitives,decode,encode}`` on the same inputs,
made from seeds with numpy, exactly (tolerance 0: bytes and int32 flags);
then the runtime: the ``portable`` engine's streams against the JAX
``runtime.compress(engine="xla")``, its decompress verdicts and bytes on
whole-stream mutants, the ``cuda`` and ``torch`` engines' envelope fallback
against the JAX ``pallas`` engine's fallback to ``xla``, ``strict_engine``,
``from_reference`` of the JAX default config and the CLI without a GPU.
The card's side is in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import warnings

import jax
import numpy as np
import pytest
import torch

from pim_compression_tpu import runtime as ref_runtime
from pim_compression_tpu.ops import decode as ref_decode
from pim_compression_tpu.ops import encode as ref_encode
from pim_compression_tpu.ops import primitives as ref_P
from pim_compression_tpu.runtime import pipeline as ref_pipeline
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu.utils.errors import SnappyError as RefSnappyError
from pim_compression_tpu.utils.errors import SnappyStatus as RefSnappyStatus
from pim_compression_tpu_torch import TorchCodecConfig, cli, native, runtime
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.ops import decode, encode, hopper_decode, hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.ops import primitives as P
from pim_compression_tpu_torch.parallel import resolve_device
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus
from test_fuzz_malformed import _mutants

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

ERRORS = (SnappyError, RefSnappyError, ValueError, OverflowError)  # typed errors; anything else is a crash


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Primitives.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_steps", [1, 7, 50, 64])
def test_orbit_positions_match_reference(num_steps):
    rng = np.random.default_rng(num_steps)
    n = 64
    forward = np.minimum(np.arange(n)[None] + rng.integers(1, 6, (3, n)), n - 1)  # tag-chain shaped
    anywhere = rng.integers(0, n, (3, n))  # any function: cycles included
    nxt = np.concatenate([forward, anywhere]).astype(np.int32)
    want = np.asarray(jax.vmap(functools.partial(ref_P.orbit_positions, num_steps=num_steps))(nxt))
    got = P.orbit_positions(_t(nxt), num_steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _rounds_to_resolve(src: np.ndarray, cap: int) -> int:
    """Rounds the reference's while_loop runs on a batch: until no pointer is
    left, at most ``cap`` (cap + 1 = never resolved)."""
    s = src.copy()
    n = s.shape[-1]
    for r in range(cap + 1):
        if not (s >= 0).any():
            return r
        hop = np.take_along_axis(s, np.clip(s, 0, n - 1), -1)
        s = np.where(s >= 0, hop, s)
    return cap + 1


def _chains(kind: str, rng: np.random.Generator, nb: int = 4, n: int = 64) -> np.ndarray:
    lit = -np.arange(n, dtype=np.int32) - 1
    src = np.tile(lit, (nb, 1))
    for b in range(nb):
        i = 0
        while i < n:
            length = int(rng.integers(2, 3 if kind == "one-round" else 21))
            for j in range(i + 1, min(i + length, n)):
                # one-round: every copy points at a literal; few-rounds: runs
                # of overlapping copies (offset 1 or 2), chains of up to 19 hops
                src[b, j] = j - 1 if kind == "one-round" else max(i, j - int(rng.integers(1, 3)))
            i += length
        if kind == "self-loops":
            loops = rng.choice(n, 5, replace=False)
            src[b, loops] = loops
            src[b, np.minimum(loops + 1, n - 1)] = loops  # chains into a loop
    return src


@pytest.mark.parametrize("kind, rounds", [("one-round", (1, 1)), ("few-rounds", (2, 5)), ("self-loops", (7, 7))])
def test_resolve_copy_chains_match_reference(kind, rounds):
    # The port runs a fixed ceil_log2(n) rounds where the reference stops
    # once no pointer is left; the results are the same.
    src = _chains(kind, np.random.default_rng(len(kind)))
    num_rounds = ref_P.ceil_log2(src.shape[-1])  # 6
    assert rounds[0] <= _rounds_to_resolve(src, num_rounds) <= rounds[1]  # 7: never resolved
    want = np.asarray(jax.vmap(lambda s: ref_P.resolve_copy_chains(s, num_rounds))(src))
    got = P.resolve_copy_chains(_t(src), num_rounds)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "self-loops":
        assert (got.numpy() >= 0).any()


def test_covering_element_repeated_starts():
    rng = np.random.default_rng(5)
    starts = np.sort(rng.integers(0, 30, (6, 12)), axis=-1).astype(np.int32)
    starts[0] = 0  # every element starts at 0
    starts[1, 6:] = 100  # starts past every output index
    starts[2, :4] = 3  # no start at 0
    want = np.asarray(jax.vmap(lambda s: ref_P.covering_element(s, 40))(starts))
    got = P.covering_element(_t(starts), 40)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_exclusive_cumsum_keeps_int32():
    x = np.random.default_rng(1).integers(0, 1000, (3, 50)).astype(np.int32)
    got = P.exclusive_cumsum(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.vmap(ref_P.exclusive_cumsum)(x)))


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------


def _stream_blocks(stream: bytes) -> list[tuple[bytes, int]]:
    info = pipeline.scan_frames(stream)
    return [(stream[o : o + s], int(n)) for o, s, n in zip(info["payload_off"], info["payload_size"], info["out_size"])]


def _slots(blocks, bs: int):
    """(slot bytes, comp_len, out_len) triples -> zero-padded [nb, cap] slots."""
    cap = pipeline.padded_capacity(bs)
    comp = np.zeros((len(blocks), cap), np.uint8)
    clen = np.zeros(len(blocks), np.int32)
    olen = np.zeros(len(blocks), np.int32)
    for i, (payload, comp_len, out_len) in enumerate(blocks):
        comp[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        clen[i], olen[i] = comp_len, out_len
    return comp, clen, olen


def _valid_blocks(bs: int, count: int) -> list[tuple[bytes, int, int]]:
    data = streams.text_payload(count * bs - bs // 3, bs)
    blocks = _stream_blocks(native.compress(data, bs) if native.available() else oracle.compress(data, bs))
    if bs >= 100:
        blocks = [blk for blk in streams.hand_blocks(bs) if blk[1] <= bs] + blocks
    # The most elements a slot holds: one-byte literals, two bytes each, so
    # the tag chain's orbit needs nearly all of its cap // 2 + 2 steps.
    dense = min(bs, pipeline.padded_capacity(bs) // 2)
    blocks.append((b"".join(bytes([0, 65 + i % 26]) for i in range(dense)), dense))
    return [(p, len(p), n) for p, n in blocks]


def _assert_decode_matches(blocks, bs: int):
    comp, clen, olen = _slots(blocks, bs)
    want_out, want_err = (np.asarray(a) for a in ref_decode.decode_blocks(comp, clen, olen, block_size=bs))
    out, err = decode.decode_blocks(_t(comp), _t(clen), _t(olen), block_size=bs)
    assert out.dtype == torch.uint8 and err.dtype == torch.int32
    np.testing.assert_array_equal(err.numpy(), want_err)
    np.testing.assert_array_equal(out.numpy(), want_out)
    return err.numpy()


@pytest.mark.parametrize("bs", [1, 100, 1000, 1024, 4097, 65536])
def test_decode_blocks_match_reference(bs):
    count = {1: 40, 65536: 2}.get(bs, 4)
    blocks = _valid_blocks(bs, count)
    pairs = [(p, n) for p, _, n in blocks if len(p) >= 2]
    muts = streams.block_mutants(pairs, random.Random(bs), 8, bs) if bs >= 100 else []
    err = _assert_decode_matches(blocks + [(p, len(p), n) for p, n in muts], bs)
    assert not err[: len(blocks)].any()
    comp, clen, olen = _slots(blocks, bs)
    out, _ = decode.decode_blocks(_t(comp), _t(clen), _t(olen), block_size=bs)
    for i, (payload, _, n) in enumerate(blocks):
        assert out[i, :n].numpy().tobytes() == oracle.decompress(streams.frame_block(payload, n, bs))


def _targeted_mutants(blocks, rng: random.Random, bs: int) -> list[tuple[bytes, int, int]]:
    """Bit flips, stomps, comp_len and out_len off by one (the slot keeps
    its bytes), a 4-byte literal length with a nonzero 5th byte, copy-4
    tags (a long offset, a flipped tag), offset 0 and an offset before the
    block's start."""
    cap = pipeline.padded_capacity(bs)
    out = []
    for _ in range(20):
        payload, clen, olen = rng.choice(blocks)
        b = bytearray(payload)
        b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        out.append((bytes(b), clen, olen))
        b = bytearray(payload)
        at = rng.randrange(len(b))
        for i in range(at, min(len(b), at + rng.randrange(1, 9))):
            b[i] = rng.randrange(256)
        out.append((bytes(b), clen, olen))
        for d in (-1, 1):
            out.append((payload, min(cap, max(0, clen + d)), olen))
            out.append((payload, clen, min(bs, max(0, olen + d))))
    data = bytes(range(1, 41))
    lit4 = bytes([63 << 2]) + (len(data) - 1).to_bytes(3, "little") + b"\x01" + data
    out.append((lit4, len(lit4), len(data)))  # the 5th byte is the length's 4th: _TOO_BIG
    for off4 in ((5).to_bytes(4, "little"), b"\x05\x00\x00\x01"):
        blk = bytes([5 << 2]) + b"ABCDEF" + bytes([3 | (7 << 2)]) + off4
        out.append((blk, len(blk), 14))  # a copy-4, then one whose offset's 4th byte is set
    for payload, clen, olen in blocks[:12]:
        elems = streams._elements(payload)
        for p, kind, o in elems:
            b = bytearray(payload)
            if kind == 2:
                b[p] |= 3  # a copy-2 read as a copy-4
                out.append((bytes(b), clen, olen))
            if kind in (1, 2):
                for off in (0, o + 1):  # offset 0; reaching before the block's start
                    b = bytearray(payload)
                    if kind == 1:
                        off = min(off, 2047)
                        b[p] = (b[p] & 0x1F) | ((off >> 8) << 5)
                        b[p + 1] = off & 0xFF
                    else:
                        b[p + 1 : p + 3] = min(off, 65535).to_bytes(2, "little")
                    out.append((bytes(b), clen, olen))
                break
    return out


def test_decode_block_mutants_at_1024():
    bs = 1024
    blocks = _valid_blocks(bs, 8)
    pairs = [(p, n) for p, _, n in blocks]
    muts = [(p, len(p), n) for p, n in streams.block_mutants(pairs, random.Random(7), 120, bs)]
    muts += _targeted_mutants(blocks, random.Random(8), bs)
    assert len(muts) >= 200
    err = _assert_decode_matches(blocks + muts, bs)
    bad = err[len(blocks) :] != 0
    assert bad.sum() > len(muts) // 3 and (~bad).sum() > 0
    assert {1, 2, 4} <= {int(e) & bit for e in err for bit in (1, 2, 4)}  # every error bit is met


# ---------------------------------------------------------------------------
# Encode.
# ---------------------------------------------------------------------------


def _encode_inputs(bs: int) -> tuple[np.ndarray, np.ndarray]:
    """Text, random, zeros, short lengths (0-4), literal runs of 59-61 and
    255-257 bytes between repeats, and runs longer than 64; bytes past a
    block's length are zero, as the runtime's blockize leaves them."""
    rng = np.random.default_rng(bs)
    text = np.frombuffer(streams.text_payload(2 * bs + 64, bs), np.uint8)
    rows = [text[:bs], text[bs : 2 * bs], rng.integers(0, 256, bs, dtype=np.uint8), np.zeros(bs, np.uint8)]
    for runs in ((59, 60, 61), (255, 256, 257)):
        parts = []
        for n in runs:
            parts += [text[:40], rng.integers(0, 256, n, dtype=np.uint8)]  # a literal run of n bytes
        parts.append(np.full(200, 7, np.uint8))  # a run longer than 64: chained copies
        parts.append(np.tile(text[:13], 20))
        rows.append(np.resize(np.concatenate(parts), bs))
    blocks = np.stack(rows)
    lens = np.full(len(rows), bs, np.int32)
    short = np.zeros((5, bs), np.uint8)
    blocks = np.concatenate([blocks, short])
    lens = np.concatenate([lens, np.minimum(np.arange(5), bs).astype(np.int32)])
    lens[1] = bs - bs // 3  # a partial block
    for i, n in enumerate(lens):
        if i >= len(rows):
            blocks[i, :n] = text[:n]
        blocks[i, n:] = 0
    return blocks, lens


@pytest.mark.parametrize("prev_k", [1, 2], ids=["prev-k-1", "defaults"])
@pytest.mark.parametrize("bs", [1, 3, 100, 1024, 4097, 8192, 65536])
def test_encode_blocks_match_reference(bs, prev_k):
    blocks, lens = _encode_inputs(bs)
    ref_k = prev_k
    if bs < prev_k:
        # The reference's encode fails when prev_k exceeds the block size
        # (its k-th predecessor list is longer than the block). No 4-gram
        # fits a block under 4 bytes, so every prev_k has no candidate and
        # gives the stream of prev_k 1.
        with pytest.raises(ValueError):
            ref_encode.encode_blocks(blocks, lens, block_size=bs, prev_k=prev_k)
        ref_k = 1
    want_comp, want_sizes = (np.asarray(a) for a in ref_encode.encode_blocks(blocks, lens, block_size=bs, prev_k=ref_k))
    comp, sizes = encode.encode_blocks(_t(blocks), _t(lens), block_size=bs, prev_k=prev_k)
    assert comp.dtype == torch.uint8 and sizes.dtype == torch.int32
    assert comp.shape == (len(lens), pipeline.padded_capacity(bs))
    np.testing.assert_array_equal(sizes.numpy(), want_sizes)
    np.testing.assert_array_equal(comp.numpy(), want_comp)
    out, err = decode.decode_blocks(comp, sizes, _t(lens), block_size=bs)
    assert not err.any()
    for i, n in enumerate(lens):
        assert out[i, :n].numpy().tobytes() == blocks[i, :n].tobytes()


# ---------------------------------------------------------------------------
# The runtime's portable engine.
# ---------------------------------------------------------------------------


def _payload(bs: int, blocks: int) -> bytes:
    """Text blocks, two random ones spliced in (the triage diverts them) and
    a partial last block."""
    rng = np.random.default_rng(bs + blocks)
    data = bytearray(streams.text_payload(blocks * bs - bs // 3, bs + 1))
    for i in (1, blocks - 2):
        data[i * bs : (i + 1) * bs] = rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    return bytes(data)


@functools.lru_cache(maxsize=None)
def _xla_stream(data: bytes, bs: int) -> tuple[bytes, dict]:
    timer = ref_runtime.PhaseTimer()
    return bytes(ref_runtime.compress(data, CodecConfig(engine="xla", block_size=bs), timer)), dict(timer.notes)


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("bs, blocks", [(1024, 7), (4096, 5), (65536, 4)])
def test_runtime_portable_compress_equals_xla_engine(bs, blocks, depth):
    data = _payload(bs, blocks)
    want, notes = _xla_stream(data, bs)
    cfg = TorchCodecConfig(engine="portable", device="cpu", block_size=bs, batch_blocks=2, pipeline_depth=depth,
                           verify=True)
    timer = runtime.PhaseTimer()
    launches = hopper_match.LAUNCHES, hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES
    assert bytes(runtime.compress(data, cfg, timer)) == want
    assert timer.notes == notes and notes["raw_blocks"] == 2
    assert bytes(runtime.decompress(want, cfg)) == data
    assert oracle.decompress(want) == data
    assert (hopper_match.LAUNCHES, hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES) == launches


def _xla_verdict(m: bytes) -> tuple[bool, bytes | None]:
    try:
        return True, bytes(ref_runtime.decompress(m, CodecConfig(engine="xla", validate=True)))
    except ERRORS:
        return False, None


def _xla_unvalidated(m: bytes) -> bytes | None:
    """What the reference's xla decompress gives with validate=False on
    freshly zeroed slots: its frame scan, its decode, rows assembled."""
    try:
        info = ref_pipeline.scan_frames(m)
    except ERRORS:
        return None
    nb, bs, total = len(info["payload_off"]), int(info["block_size"]), int(info["total_len"])
    if nb == 0:
        return b""
    blocks = [(m[o : o + s], int(s), int(n)) for o, s, n in zip(info["payload_off"], info["payload_size"],
                                                                info["out_size"])]
    if max(s for _, s, _ in blocks) > pipeline.padded_capacity(bs):
        return None
    out, _ = ref_decode.decode_blocks(*_slots(blocks, bs), block_size=bs)
    return np.asarray(out).reshape(-1)[:total].tobytes()


@pytest.mark.parametrize("bs, blocks, n", [(1024, 3, 60), (4096, 2, 24)])
def test_decompress_verdicts_on_fuzzed_streams(bs, blocks, n):
    data = streams.text_payload(blocks * bs - bs // 3, bs)
    stream = native.compress(data, bs) if native.available() else oracle.compress(data, bs)
    muts = list(_mutants(stream, random.Random(0xA5 + bs), n))
    strict = TorchCodecConfig(engine="portable", device="cpu", validate=True)
    loose = dataclasses.replace(strict, validate=False)
    oks = 0
    for m in muts:
        try:
            got = True, bytes(runtime.decompress(m, strict))
        except ERRORS:
            got = False, None
        assert got == _xla_verdict(m)
        oks += got[0]
        want = _xla_unvalidated(m)
        try:
            loose_out = bytes(runtime.decompress(m, loose))
        except ERRORS:
            loose_out = None
        assert loose_out == want
    assert 0 < oks < len(muts)


# ---------------------------------------------------------------------------
# The envelope fallback and strict_engine.
# ---------------------------------------------------------------------------

FALLBACKS = {
    "bs-100": dict(block_size=100), "bs-128": dict(block_size=128), "bs-1000": dict(block_size=1000),
    "sweep-16512": dict(block_size=16384 + 128, matcher="sweep"), "sweep-32768": dict(block_size=32768, matcher="sweep"),
}


@pytest.mark.parametrize("knobs", FALLBACKS.values(), ids=FALLBACKS.keys())
def test_fallback_matches_reference_pallas_engine(knobs):
    data = _payload(knobs["block_size"], 4)
    ref_timer, timer = ref_runtime.PhaseTimer(), runtime.PhaseTimer()
    with pytest.warns(UserWarning, match="falling back to the xla engine"):
        want = bytes(ref_runtime.compress(data, CodecConfig(engine="pallas", **knobs), ref_timer))
    launches = hopper_match.LAUNCHES, hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES
    with pytest.warns(UserWarning, match="falling back to the portable engine"):
        got = bytes(runtime.compress(data, TorchCodecConfig(engine="torch", **knobs), timer))
    assert got == want
    assert (hopper_match.LAUNCHES, hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES) == launches
    ref_gap = ref_timer.notes.pop("engine_fallback").removeprefix("pallas->xla (")
    gap = timer.notes.pop("engine_fallback").removeprefix("torch->portable (")
    assert gap.split(" (")[0] == ref_gap.split(" (")[0]  # the same gap; the reason in brackets is each one's own
    assert timer.notes == ref_timer.notes
    with pytest.raises(RefSnappyError) as e:
        ref_runtime.compress(data, CodecConfig(engine="pallas", strict_engine=True, **knobs))
    assert e.value.status == RefSnappyStatus.BAD_ARGUMENT
    for engine in ("torch", "cuda"):  # before the device, so also without a GPU
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(SnappyError) as e:
                runtime.compress(data, TorchCodecConfig(engine=engine, strict_engine=True, **knobs))
        assert e.value.status == SnappyStatus.BAD_ARGUMENT and "falling back" in str(e.value)
    assert (hopper_match.LAUNCHES, hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES) == launches


def test_decompress_never_falls_back():
    # Decode runs the kernels (here their plain versions) at every block
    # size: no warning, and strict_engine does not raise.
    data = streams.text_payload(3000, 4)
    stream = oracle.compress(data, 100)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = TorchCodecConfig(engine="torch", strict_engine=True)
        assert bytes(runtime.decompress(stream, cfg)) == data


def test_from_reference_default_config():
    ref = CodecConfig()
    assert ref.engine == "xla"
    cfg = TorchCodecConfig.from_reference(ref, device="cpu")
    assert cfg.engine == "portable" and cfg.block_size == ref.block_size == 32768
    data = _payload(32768, 3)
    assert bytes(runtime.compress(data, cfg)) == _xla_stream(data, 32768)[0]


def test_portable_engine_device(monkeypatch):
    assert resolve_device("portable", "cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = b"portable " * 200
    for kw in ({}, {"device": "cuda:0"}):  # never quietly on the CPU
        with pytest.raises(SnappyError) as e:
            resolve_device("portable", kw.get("device"))
        assert e.value.status == SnappyStatus.BAD_ARGUMENT
        cfg = TorchCodecConfig(engine="portable", block_size=1024, **kw)
        for call in (lambda: runtime.compress(data, cfg), lambda: runtime.decompress(oracle.compress(data, 1024), cfg)):
            with pytest.raises(SnappyError) as e:
                call()
            assert e.value.status == SnappyStatus.BAD_ARGUMENT


@pytest.mark.parametrize("compress", [True, False], ids=["compress", "decompress"])
def test_cli_portable_engine_needs_a_gpu(compress, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = streams.text_payload(5000, 6)
    src = tmp_path / "in.bin"
    src.write_bytes(data if compress else oracle.compress(data, 1024))
    out = tmp_path / "out.bin"
    argv = ["-c"] * compress + ["-b", "1024", "--engine", "portable", "-i", str(src), "-o", str(out)]
    assert cli.main(argv) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_portable_functions_reject_bad_tensors():
    blocks, lens = (_t(a) for a in _encode_inputs(256))
    with pytest.raises(ValueError):
        encode.encode_blocks(blocks, lens, block_size=512)  # not the data's width
    with pytest.raises(ValueError):
        encode.encode_blocks(blocks, lens.long(), block_size=256)
    with pytest.raises(ValueError):
        encode.encode_blocks(blocks.to(torch.int32), lens, block_size=256)
    comp, sizes = encode.encode_blocks(blocks, lens, block_size=256)
    with pytest.raises(ValueError):
        decode.decode_blocks(comp, sizes.long(), lens, block_size=256)
    with pytest.raises(ValueError):
        decode.decode_blocks(comp[:, :0], sizes, lens, block_size=256)
    with pytest.raises(ValueError):
        decode.decode_blocks(comp, sizes, lens, block_size=0)
