"""Whole streams through the port's decode, held against the reference's engines.

Two gaps in the port's decode tests, closed here on the ``torch`` engine
(the plain PyTorch decode on the CPU; ``test_torch_cuda.py`` holds the
``cuda`` engine to it on the card):

- block sizes outside the encoder's envelope (100, 1000, 4097: not
  multiples of 16, so the kernel's byte-wise row writes). The reference's
  ``pallas`` engine warns and falls back to its ``xla`` engine there; the
  port decodes them directly. Streams are compared with the port's oracle
  and the reference's ``runtime.decompress``; block mutants' verdicts and
  valid bytes with the reference's ``xla`` decode and the oracle;
- a fuzz of whole malformed streams (``test_fuzz_malformed._mutants``: bit
  flips biased to the header, truncations, stomps, garbage tails) of
  generated streams at bs 1024 and 4096, through ``runtime.decompress``:
  error, not crash; the reference ``pallas`` engine's verdict on every
  mutant (its frame scan on each, then one batched decode of every block
  that passed it; a few mutants also through its ``runtime.decompress``, to
  show the batching gives the engine's verdict); and the reference's oracle
  and native engines on at least 99 % of mutants, or on all but one, the
  seed fuzz test's bars for its engines.
"""

from __future__ import annotations

import random
import warnings

import numpy as np
import pytest
import torch

from pim_compression_tpu import native as ref_native
from pim_compression_tpu import runtime as ref_runtime
from pim_compression_tpu.format import oracle as ref_oracle
from pim_compression_tpu.ops import decode as ref_decode
from pim_compression_tpu.ops import pallas_decode
from pim_compression_tpu.runtime import pipeline as ref_pipeline
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu.utils.errors import SnappyError as RefSnappyError
from pim_compression_tpu_torch import TorchCodecConfig, native, runtime
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.ops import hopper_decode
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams
from pim_compression_tpu_torch.utils.errors import SnappyError
from test_fuzz_malformed import _mutants

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

ODD_SIZES = [100, 1000, 4097]
ERRORS = (SnappyError, RefSnappyError, ValueError, OverflowError)  # typed errors; anything else is a crash
TORCH = TorchCodecConfig(engine="torch", device="cpu", validate=True)
# bs -> (blocks in the generated stream, mutants): the torch engine steps
# once per payload byte of a batch's longest block, about 0.5 ms a step here.
FUZZ = {1024: (3, 100), 4096: (2, 24)}
ENGINE_CHECKS = 2  # mutants per size also run through the reference's runtime.decompress


def _text_stream(bs: int, blocks: int) -> tuple[bytes, bytes]:
    data = streams.text_payload(blocks * bs - bs // 3, bs)  # a partial last block
    return data, native.compress(data, bs)


def _stream_blocks(stream: bytes) -> list[tuple[bytes, int]]:
    info = pipeline.scan_frames(stream)
    return [(stream[o : o + s], int(n)) for o, s, n in zip(info["payload_off"], info["payload_size"], info["out_size"])]


def _slots(blocks, bs: int):
    cap = pipeline.padded_capacity(bs)
    comp = np.zeros((len(blocks), cap), np.uint8)
    clen = np.zeros(len(blocks), np.int32)
    olen = np.zeros(len(blocks), np.int32)
    for i, (payload, n) in enumerate(blocks):
        comp[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        clen[i], olen[i] = len(payload), n
    return comp, clen, olen


def _outcome(fn, stream: bytes):
    """(ok, output bytes or None): a typed error is a verdict, anything else propagates."""
    try:
        return True, bytes(fn(stream))
    except ERRORS:
        return False, None


# --- block sizes outside the encoder's envelope --------------------------


@pytest.mark.parametrize("bs", ODD_SIZES)
def test_torch_engine_decodes_odd_block_sizes(bs):
    data, stream = _text_stream(bs, 8)
    small = data[: 3 * bs + 7]
    for payload, s in ((data, stream), (small, oracle.compress(small, bs))):
        assert bytes(runtime.decompress(s, TORCH)) == payload
        assert oracle.decompress(s) == payload
        with pytest.warns(UserWarning, match="falling back to the xla engine"):
            ref = ref_runtime.decompress(s, CodecConfig(engine="pallas", block_size=bs, validate=True))
        assert bytes(ref) == payload


@pytest.mark.parametrize("bs", ODD_SIZES)
def test_torch_decode_odd_block_size_mutants(bs):
    _, stream = _text_stream(bs, 6)
    base = [blk for blk in streams.hand_blocks(bs) if blk[1] <= bs] + _stream_blocks(stream)
    blocks = base + streams.block_mutants(base, random.Random(bs), 48, bs)
    comp, clen, olen = _slots(blocks, bs)
    out, err = (t.numpy() for t in hopper_decode.decode_blocks_torch(*map(torch.from_numpy, (comp, clen, olen)), bs))
    out_r, err_r = (np.asarray(a) for a in ref_decode.decode_blocks(comp, clen, olen, block_size=bs))
    assert not err[: len(base)].any()
    np.testing.assert_array_equal(err != 0, err_r != 0)
    for i, (payload, n) in enumerate(blocks):
        try:
            want = oracle.decompress(streams.frame_block(payload, n, bs))
        except ValueError:
            want = None
        assert (want is None) == (err[i] != 0), f"block {i}"
        if want is not None:
            assert out[i, :n].tobytes() == out_r[i, :n].tobytes() == want
            assert not out[i, n:].any()


# --- a fuzz of whole malformed streams ------------------------------------


def _reference_pallas_verdicts(muts: list[bytes], bs: int) -> list[bool]:
    """The reference pallas engine's verdict (with validate) on each mutant:
    its frame scan, then one interpret-mode decode of every block of every
    mutant that passed the scan and declares bs (others, a flipped block
    size, go through its runtime.decompress)."""
    verdicts: list[bool | None] = [None] * len(muts)
    rows, owner = [], []
    for i, m in enumerate(muts):
        try:
            info = ref_pipeline.scan_frames(m)
        except ERRORS:
            verdicts[i] = False
            continue
        if len(info["payload_off"]) == 0:
            verdicts[i] = True
        elif int(info["block_size"]) != bs:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # a declared size outside the pallas envelope falls back
                verdicts[i] = _outcome(lambda s: ref_runtime.decompress(s, CodecConfig(engine="pallas", validate=True)),
                                       m)[0]
        else:
            slots = ref_pipeline.blockize_compressed(m, info, len(info["payload_off"]))
            rows.append(tuple(a.copy() for a in slots))  # views of a staging buffer the next call reuses
            clen = slots[1]
            owner += [i] * len(clen)
    if rows:
        comp, clen, olen = (np.concatenate(parts) for parts in zip(*rows))
        pad = -len(clen) % pallas_decode.LANES
        comp = np.pad(comp, ((0, pad), (0, 0)))
        clen, olen = np.pad(clen, (0, pad)), np.pad(olen, (0, pad))
        _, err = pallas_decode.decode_blocks_pallas(comp, clen, olen, block_size=bs, interpret=True)
        bad = {owner[k] for k in np.nonzero(np.asarray(err)[: len(owner)])[0]}
        for i in set(owner):
            verdicts[i] = i not in bad
    return verdicts


@pytest.mark.parametrize("bs", sorted(FUZZ))
def test_fuzz_torch_engine_against_reference_engines(bs):
    blocks, n = FUZZ[bs]
    _, stream = _text_stream(bs, blocks)
    muts = list(_mutants(stream, random.Random(0xF2 + bs), n))
    port = [_outcome(lambda s: runtime.decompress(s, TORCH), m) for m in muts]
    pallas = _reference_pallas_verdicts(muts, bs)
    assert [ok for ok, _ in port] == pallas
    # The batched verdicts are the engine's: a few mutants that reach the
    # decode through the reference's runtime itself.
    checked = 0
    for i, m in enumerate(muts):
        if checked < ENGINE_CHECKS and _scans(m, bs):
            got = _outcome(lambda s: ref_runtime.decompress(s, CodecConfig(engine="pallas", validate=True)), m)
            assert got[0] == pallas[i] and (not got[0] or got[1] == port[i][1])
            checked += 1
    assert checked == ENGINE_CHECKS
    host = {"oracle": ref_oracle.decompress}
    if ref_native.available():
        host["native"] = lambda s: ref_native.decompress(s, num_threads=1)
    for name, fn in host.items():
        agree = 0
        for (ok, out), m in zip(port, muts):
            ok_h, out_h = _outcome(fn, m)
            if ok_h == ok:
                agree += 1
                assert out == out_h, name  # both decode: the same bytes
        # The seed's bar: 99 %, or one semantic borderline in a small set (a
        # flipped block-size varint: the oracle decodes a block at the new
        # size that the block-parallel engines flag).
        assert agree >= min(0.99 * len(muts), len(muts) - 1), f"{name} agrees on {agree}/{len(muts)}"
    assert sum(ok for ok, _ in port) > 0 and sum(not ok for ok, _ in port) > len(muts) // 4


def _scans(m: bytes, bs: int) -> bool:
    """Whether the reference's frame scan takes m with block size bs."""
    try:
        info = ref_pipeline.scan_frames(m)
    except ERRORS:
        return False
    return len(info["payload_off"]) > 0 and int(info["block_size"]) == bs
