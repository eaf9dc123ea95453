"""Kernel debug dump: one block's phases, plain PyTorch version vs CUDA kernel.

Counterpart of ``pim_compression_tpu.utils.debug`` (the reference's DEBUG
build and ``dbg_printf``, ``snappy/Makefile:6-8``). For ONE block every
phase is computed twice on the GPU: by the plain PyTorch version and by the
hand-written kernel the ``cuda`` engine runs, on the same CUDA tensors; the
first mismatch of each phase is printed and both sides go to an ``.npz``.

Encode phases (the matcher the config names, then the emit):
    match.len / match.lag   match_blocks_torch vs match_blocks (or the sweep's pair)
    emit.size / emit.bytes  emit_blocks_torch vs emit_blocks, each on its own matcher's output
Decode phases (one framed block's payload):
    decode.bytes / decode.err  decode_blocks_torch vs decode_blocks

The dump needs the ``cuda`` engine and a GPU (``SnappyError(BAD_ARGUMENT)``
otherwise): the plain version against itself on the CPU checks nothing.
CLI: ``--debug-block N`` (or ``PIM_DEBUG_BLOCK=N``); output
``pim_debug_block.npz`` (``PIM_DEBUG_OUT`` overrides).
"""

from __future__ import annotations

import os
import pathlib
import struct

import numpy as np
import torch

from pim_compression_tpu_torch.format.varint import decode_varint32
from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.parallel import resolve_device
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus


def _device(config) -> torch.device:
    if config.engine != "cuda":
        raise SnappyError(
            SnappyStatus.BAD_ARGUMENT,
            f"the debug dump holds the plain versions against the CUDA kernels: it needs the "
            f"cuda engine, not {config.engine!r}",
        )
    return resolve_device("cuda", config.device)


def _report(phases, dump: dict, out_path) -> int:
    """Print each phase's first mismatch, write the dump; returns the count
    of phases that differ."""
    bad = 0
    for phase in phases:
        a, b = dump[f"plain.{phase}"], dump[f"kernel.{phase}"]
        if a.shape != b.shape:
            print(f"  {phase:<13} SHAPE MISMATCH plain{a.shape} kernel{b.shape}")
            bad += 1
            continue
        neq = np.flatnonzero(a.ravel() != b.ravel())
        if neq.size:
            i = int(neq[0])
            print(f"  {phase:<13} FIRST MISMATCH at {i}: plain={a.ravel()[i]} kernel={b.ravel()[i]} "
                  f"({neq.size} of {a.size} differ)")
            bad += 1
        else:
            print(f"  {phase:<13} OK ({a.size} values)")
    path = pathlib.Path(out_path or os.environ.get("PIM_DEBUG_OUT", "pim_debug_block.npz"))
    np.savez_compressed(path, **dump)
    print(f"  {bad} phases differ; wrote {path}")
    return bad


def debug_encode_block(block: bytes, config, out_path: str | None = None) -> int:
    """Dump the encode phases of one block (at most ``config.block_size``
    bytes) with the config's matcher knobs; returns the count of phases
    whose plain and kernel values differ."""
    device = _device(config)
    bs = config.block_size
    knobs = hopper_encode.encode_knobs(config)
    sweep = knobs.pop("matcher", "sorted") == "sweep"
    match, match_plain = (
        (hopper_sweep.sweep_match, hopper_sweep.sweep_match_torch) if sweep
        else (hopper_match.match_blocks, hopper_match.match_blocks_torch)
    )
    row = np.zeros((1, bs), np.uint8)
    row[0, : len(block)] = np.frombuffer(block, np.uint8)
    blocks = torch.from_numpy(row).to(device)
    lens = torch.tensor([len(block)], dtype=torch.int32, device=device)
    cap = pipeline.padded_capacity(bs)
    dump = {"data": row[0]}
    for side, find, emit in (
        ("plain", match_plain, hopper_encode.emit_blocks_torch),
        ("kernel", match, hopper_encode.emit_blocks),
    ):
        mlen, mlag = find(blocks, lens, **knobs)
        comp, sizes = emit(blocks, lens, mlen, mlag, cap)
        torch.cuda.synchronize(device)
        size = int(sizes[0])
        dump[f"{side}.match.len"] = mlen[0].cpu().numpy()
        dump[f"{side}.match.lag"] = mlag[0].cpu().numpy().view(np.uint16)
        dump[f"{side}.emit.size"] = np.array([size])
        dump[f"{side}.emit.bytes"] = comp[0, : max(0, min(size, cap))].cpu().numpy()
    print(f"debug_encode_block: {len(block)} bytes at bs {bs}, knobs {knobs}{' (sweep)' if sweep else ''}")
    return _report(("match.len", "match.lag", "emit.size", "emit.bytes"), dump, out_path)


def stream_block(stream: bytes, index: int):
    """(payload, block_size, out_len) of block ``index`` of a framed
    stream, or None past its last block."""
    total, pos = decode_varint32(stream, 0)
    block_size, pos = decode_varint32(stream, pos)
    if index < 0:
        return None
    for _ in range(index):  # skip the frames before it: a u32 size, then the payload
        if pos + 4 > len(stream):
            return None
        pos += 4 + struct.unpack_from("<I", stream, pos)[0]
    if pos + 4 > len(stream):
        return None
    (size,) = struct.unpack_from("<I", stream, pos)
    return stream[pos + 4 : pos + 4 + size], block_size, min(block_size, total - index * block_size)


def debug_decode_block(payload: bytes, block_size: int, out_len: int, config, out_path: str | None = None) -> int:
    """Dump the decode phases of one block's payload; returns the count of
    phases whose plain and kernel values differ."""
    device = _device(config)
    cap = max(pipeline.padded_capacity(block_size), len(payload))
    comp = np.zeros((1, cap), np.uint8)
    comp[0, : len(payload)] = np.frombuffer(payload, np.uint8)
    comp_d = torch.from_numpy(comp).to(device)
    clen = torch.tensor([len(payload)], dtype=torch.int32, device=device)
    olen = torch.tensor([out_len], dtype=torch.int32, device=device)
    dump = {"payload": comp[0, : len(payload)]}
    for side, out, err in (
        ("plain", *hopper_decode.decode_blocks_torch(comp_d, clen, olen, block_size)),
        ("kernel", *hopper_decode.decode_blocks(comp_d, clen, olen, block_size=block_size)),
    ):
        dump[f"{side}.decode.bytes"] = out[0, :out_len].cpu().numpy()
        dump[f"{side}.decode.err"] = np.array([int(err[0])])
    print(f"debug_decode_block: {len(payload)} -> {out_len} bytes at bs {block_size}")
    return _report(("decode.bytes", "decode.err"), dump, out_path)
