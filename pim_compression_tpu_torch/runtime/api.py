"""Public codec API of the port: ``compress`` / ``decompress`` with engine dispatch.

Engines:
- ``oracle``: the pure-Python arbiter (the port's copy of the reference's).
- ``native``: the C++ threaded host codec (the port's copy, passes through).
- ``cuda``: the hand-written Hopper kernels (match or sweep, emit, decode)
  on one CUDA device.
- ``torch``: their plain PyTorch versions, on the CPU or a GPU.

Ported from ``pim_compression_tpu.runtime.api``. The device engines emit
the same streams as the reference's ``pallas`` engine at the same config.
"""

from __future__ import annotations

import numpy as np
import torch

from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus
from pim_compression_tpu_torch.ops import _build, hopper_decode, hopper_encode
from pim_compression_tpu_torch.parallel import resolve_device
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.runtime.profiling import PhaseTimer
from pim_compression_tpu_torch.utils.config import TorchCodecConfig


def decompress(
    stream: bytes,
    config: TorchCodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> bytes | bytearray:
    """Decompress a framed stream.

    The device engines decode batches of ``config.batch_blocks`` blocks
    (plus a tail batch), each h2d -> decode -> d2h, straight into one output
    buffer at ``start * block_size``; they return it without a detaching copy
    when it is 1 MiB or more. Batches run synchronously. With
    ``config.validate``, a block with any error bit raises ``SnappyError``.
    """
    config = config or TorchCodecConfig()
    timer = timer if timer is not None else PhaseTimer()

    if config.engine == "oracle":
        with timer.phase("kernel"):
            return oracle.decompress(stream)
    if config.engine == "native":
        with timer.phase("kernel"):
            return native.decompress(stream, num_threads=config.num_threads)

    device = resolve_device(config.engine, config.device)
    on_cuda = device.type == "cuda"

    def sync() -> None:
        if on_cuda:
            torch.cuda.synchronize(device)

    with timer.phase("pre"):
        info = pipeline.scan_frames(stream)
        nb = len(info["payload_off"])
        block_size = int(info["block_size"])
        total_len = int(info["total_len"])
        if nb == 0:
            return b""
        comp, comp_len, out_len = pipeline.blockize_compressed(stream, info)
        comp, comp_len, out_len = (torch.from_numpy(a) for a in (comp, comp_len, out_len))
        result = native.uninit_bytearray(total_len) if native.available() else bytearray(total_len)
        flat = torch.frombuffer(result, dtype=torch.uint8)

    if config.engine == "cuda":
        with timer.phase("compile"):
            _build.load()
        decode = hopper_decode.decode_blocks
    else:
        decode = hopper_decode.decode_blocks_torch

    batch = max(1, config.batch_blocks)
    for start in range(0, nb, batch):
        stop = min(nb, start + batch)
        with timer.phase("h2d"):
            comp_d = comp[start:stop].to(device)
            clen_d = comp_len[start:stop].to(device)
            olen_d = out_len[start:stop].to(device)
            sync()
        with timer.phase("kernel"):
            out, err = decode(comp_d, clen_d, olen_d, block_size=block_size)
            sync()
        with timer.phase("d2h"):
            err_h = err.cpu()
            if config.validate and bool(err_h.any()):
                bad = int(torch.nonzero(err_h)[0, 0])
                raise SnappyError(
                    SnappyStatus.INVALID_INPUT,
                    f"block {start + bad} failed validation (flags={int(err_h[bad])})",
                )
            lo = start * block_size
            hi = min(stop * block_size, total_len)
            rows = (hi - lo) // block_size
            flat[lo : lo + rows * block_size].view(rows, block_size).copy_(out[:rows])
            if lo + rows * block_size < hi:  # final partial block
                flat[lo + rows * block_size : hi].copy_(out[rows, : hi - lo - rows * block_size])

    with timer.phase("post"):
        return bytes(result) if total_len < (1 << 20) else result


def compress(
    data: bytes,
    config: TorchCodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> bytes | bytearray:
    """Compress to a framed stream.

    The device engines blockize the input, divert incompressible blocks to
    raw literal frames (``config.raw_triage``), and encode the rest in
    batches of ``config.batch_blocks`` (plus a tail batch), each h2d ->
    match + emit -> d2h, synchronously. The sorted matcher's rung pick and
    its ``sel_all`` select ladder at 256 <= block_size <= 65536 (a multiple
    of 128) are ported, with the reference's switch to the ladder above
    32768 (``timer.notes["wide_select"]``), and so is the sweep matcher
    (``matcher="sweep"``: ``match_window``, ``coarse_window``, sampled or
    granular ``coarse_mode``) at block_size <= 16384 (granular at multiples
    of 256); any other size or knob raises ``SnappyError(BAD_ARGUMENT)``
    (``hopper_encode.encode_knobs``) and nothing falls back. With
    ``config.verify``, each batch is decoded again on its device and
    compared with its input blocks; a mismatch raises ``SnappyError``.
    """
    config = config or TorchCodecConfig()
    timer = timer if timer is not None else PhaseTimer()

    if config.engine == "oracle":
        with timer.phase("kernel"):
            return oracle.compress(data, config.block_size)
    if config.engine == "native":
        with timer.phase("kernel"):
            return native.compress(data, config.block_size, num_threads=config.num_threads)

    select_notes: dict = {}
    knobs = hopper_encode.encode_knobs(config, select_notes)
    device = resolve_device(config.engine, config.device)
    on_cuda = device.type == "cuda"
    block_size = config.block_size
    cap = pipeline.padded_capacity(block_size)

    def sync() -> None:
        if on_cuda:
            torch.cuda.synchronize(device)

    with timer.phase("pre"):
        if not data:
            return oracle.compress(b"", block_size)  # header-only stream
        blocks, lens = pipeline.blockize_plain(data, block_size)
        nb = len(lens)
        raw = pipeline.triage_incompressible(blocks, lens) if config.raw_triage else np.zeros(nb, bool)
        dev_idx = np.flatnonzero(~raw)
        if nb - dev_idx.size:
            timer.notes["raw_blocks"] = int(nb - dev_idx.size)
        if dev_idx.size:  # as the reference, noted only where a batch runs
            timer.notes.update(select_notes)
        comp = np.empty((nb, cap), dtype=np.uint8)
        sizes = np.empty(nb, dtype=np.int32)

    if config.engine == "cuda":
        with timer.phase("compile"):
            _build.load()
        encode, decode = hopper_encode.encode_blocks, hopper_decode.decode_blocks
    else:
        encode, decode = hopper_encode.encode_blocks_torch, hopper_decode.decode_blocks_torch

    batch = max(1, config.batch_blocks)
    for start in range(0, dev_idx.size, batch):
        rows = dev_idx[start : start + batch]
        with timer.phase("h2d"):
            blocks_d = torch.from_numpy(blocks[rows]).to(device)
            lens_d = torch.from_numpy(lens[rows]).to(device)
            sync()
        with timer.phase("kernel"):
            comp_d, sizes_d = encode(blocks_d, lens_d, cap=cap, **knobs)
            if config.verify:
                out_v, err_v = decode(comp_d, sizes_d, lens_d, block_size=block_size)
                inside = torch.arange(block_size, device=device)[None, :] < lens_d[:, None]
                bad = ((out_v != blocks_d) & inside).any(dim=1) | (err_v != 0)
            sync()
        with timer.phase("d2h"):
            if config.verify and bool(bad.any()):
                failed = rows[np.flatnonzero(bad.cpu().numpy())]
                raise SnappyError(
                    SnappyStatus.INVALID_INPUT,
                    f"on-device verify failed for blocks {failed[:8].tolist()}",
                )
            comp[rows] = comp_d.cpu().numpy()
            sizes[rows] = sizes_d.cpu().numpy()

    with timer.phase("post"):
        pipeline.raw_literal_frames(blocks, lens, comp, sizes, np.flatnonzero(raw))
        if config.validate and int(sizes.max(initial=0)) > cap:
            raise SnappyError(SnappyStatus.BUFFER_TOO_SMALL, "encoder overflow")
        return pipeline.assemble_compressed(comp, sizes, len(data), block_size)
