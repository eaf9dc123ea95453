"""Public codec API of the port: ``decompress`` with engine dispatch.

Engines:
- ``oracle``: the pure-Python arbiter (passes through to the reference).
- ``native``: the C++ threaded host codec (passes through).
- ``cuda``: the hand-written Hopper decode kernel on one CUDA device.
- ``torch``: the plain PyTorch decode, on the CPU or a GPU.

Ported from ``pim_compression_tpu.runtime.api.decompress``. ``compress`` for
the device engines is not ported yet: the reference's ``runtime.compress``
or ``native.compress`` produce the streams.
"""

from __future__ import annotations

import torch

from pim_compression_tpu import native
from pim_compression_tpu.format import oracle
from pim_compression_tpu.utils.errors import SnappyError, SnappyStatus
from pim_compression_tpu_torch.ops import _build, hopper_decode
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
        if block_size > hopper_decode.MAX_BLOCK_SIZE:
            raise SnappyError(
                SnappyStatus.BAD_ARGUMENT,
                f"block_size {block_size}: the {config.engine} engine decodes "
                f"blocks up to {hopper_decode.MAX_BLOCK_SIZE} bytes",
            )
        if nb == 0:
            return b""
        comp, comp_len, out_len = pipeline.blockize_compressed(stream, info)
        comp, comp_len, out_len = (torch.from_numpy(a) for a in (comp, comp_len, out_len))
        result = native.uninit_bytearray(total_len) if native.available() else bytearray(total_len)
        flat = torch.frombuffer(result, dtype=torch.uint8)

    if on_cuda:
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
