"""Device resolution for the port (counterpart of ``parallel/mesh.py``).

The reference splits the block axis over a 1-D mesh of every local device.
The port runs on one device per call; splitting over
``torch.cuda.device_count()`` cards is later work.
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus


def resolve_device(engine: str, device=None) -> torch.device:
    """The device an engine decodes on.

    "cuda" runs on a CUDA device only (default ``cuda:0``) and raises when
    none is available; it never decodes on the CPU. "torch" runs where it is
    told (default the CPU).
    """
    if engine == "cuda":
        dev = torch.device(device if device is not None else "cuda:0")
        if dev.type != "cuda":
            raise SnappyError(
                SnappyStatus.BAD_ARGUMENT, f"engine 'cuda' cannot run on {dev}"
            )
        if not torch.cuda.is_available():
            raise SnappyError(
                SnappyStatus.BAD_ARGUMENT, "engine 'cuda' needs a CUDA device; none is available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise SnappyError(SnappyStatus.BAD_ARGUMENT, f"no device {dev}")
        return dev
    if engine == "torch":
        return torch.device(device if device is not None else "cpu")
    raise SnappyError(SnappyStatus.BAD_ARGUMENT, f"engine {engine!r} has no device")
