"""What a copy costs on the card and between host and card, and what an integer op costs.

The counterpart of the JAX package's ``scripts/transfer_probe.py``, which
split the TPU's per-dispatch cost into a fixed part, a part per input byte
and a part per output byte, with trivial ``x + 1`` kernels across operand
sizes and a compute-heavy kernel. Here:

- ``copy`` at the same five (input rows, output rows) of int32 x 128 lanes,
  4 KB to 16 MB, through ``hopper_probes.copy_rows`` (``csrc/probes.cu``):
  the kernel's time by CUDA events with its input and output in device
  memory, not in L2 (``kernel_s``, and its bytes per second),
  and beside it the host round trip the JAX record's ``t_s`` measured
  (pageable h2d of the input, the launch, d2h of the output, synchronised);
  ``copy_fit`` fits ``t_s = dispatch_s + s_per_in_byte * in_bytes +
  s_per_out_byte * out_bytes`` over the five;
- ``h2d`` and ``d2h`` at the main path's batch sizes: 1024 padded
  compressed slots of a 32 KB block (what decompress copies in) and 1024
  blocks of 32 KB (what compress copies in), pageable as ``runtime/api.py``
  copies them today and, beside, pinned;
- ``compute``: the multiply-xor-shift recurrence over an int32 (4096, 128)
  plane for 100, 2000 and 8000 rounds through ``hopper_probes.mix_rounds``,
  with its int32 operations per second (three a round and element).

    python -m pim_compression_tpu_torch.scripts.transfer_probe

writes ``build/probes/transfer_probe.json``.
"""

from __future__ import annotations

import itertools
import sys

import numpy as np
import torch

from pim_compression_tpu_torch.ops import hopper_probes
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import common

LANES = hopper_probes.LANES
COPY_ROWS = [(8, 8), (4096, 8), (32768, 8), (32768, 32768), (8, 32768)]  # transfer_probe.py:67
COMPUTE = [(4096, 100), (4096, 2000), (4096, 8000)]  # transfer_probe.py:91
BATCH_BLOCKS = 1024
BLOCK_SIZE = 32768


def copy_bytes(in_rows: int, out_rows: int) -> int:
    """The bytes the copy must move: the rows it reads (one when it
    broadcasts) and the rows it writes."""
    read = out_rows if out_rows <= in_rows else 1
    return (read + out_rows) * LANES * 4


def _copy_fit(records: list[dict]) -> dict:
    a = np.array([[1.0, r["in_mb"] * 1e6, r["out_mb"] * 1e6] for r in records])
    t = np.array([r["t_s"] for r in records])
    scale = np.abs(a).max(axis=0)
    coef = np.linalg.lstsq(a / scale, t, rcond=None)[0] / scale
    return {
        "kind": "copy_fit", "model": "t_s = dispatch_s + s_per_in_byte * in_bytes + s_per_out_byte * out_bytes",
        "dispatch_s": float(coef[0]), "s_per_in_byte": float(coef[1]), "s_per_out_byte": float(coef[2]),
    }


def _host_copies(dev: torch.device, nbytes: int, what: str) -> list[dict]:
    out = []
    on_card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for pinned in (False, True):
        host = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pinned)

        def h2d():
            host.to(dev)
            torch.cuda.synchronize(dev)

        def d2h():
            if pinned:
                host.copy_(on_card)
                torch.cuda.synchronize(dev)
            else:
                on_card.cpu()

        for kind, fn in (("h2d", h2d), ("d2h", d2h)):
            t = common.host_seconds(fn)
            out.append({"kind": kind, "what": what, "bytes": nbytes, "pinned": pinned, "t_s": t,
                        "bytes_per_s": nbytes / t})
    return out


def run(device="cuda:0") -> list[dict]:
    """Every record of the probe, measured on ``device`` (a CUDA device)."""
    dev = common.cuda_device(device)
    common.warm(dev)
    card = common.card(dev)
    out = []
    for in_rows, out_rows in COPY_ROWS:
        x_host = torch.zeros((in_rows, LANES), dtype=torch.int32)
        turn, outs = itertools.cycle(common.cold_copies(x_host.to(dev))), []
        # Inputs in turn and every output kept: each call reads and writes
        # device memory, not lines a previous call left in L2.
        kernel_s = common.event_seconds(lambda: outs.append(hopper_probes.copy_rows(next(turn), out_rows)), reps=20)
        del outs
        t = common.host_seconds(lambda: hopper_probes.copy_rows(x_host.to(dev), out_rows).cpu())
        nbytes = copy_bytes(in_rows, out_rows)
        out.append({
            "kind": "copy", "in_mb": in_rows * LANES * 4 / 1e6, "out_mb": out_rows * LANES * 4 / 1e6, "t_s": t,
            "kernel_s": kernel_s, "kernel_bytes": nbytes, "kernel_bytes_per_s": nbytes / kernel_s,
        })
    out.append(_copy_fit([r for r in out if r["kind"] == "copy"]))
    out += _host_copies(dev, BATCH_BLOCKS * pipeline.padded_capacity(BLOCK_SIZE),
                        f"{BATCH_BLOCKS} padded compressed slots at bs {BLOCK_SIZE}")
    out += _host_copies(dev, BATCH_BLOCKS * BLOCK_SIZE, f"{BATCH_BLOCKS} plain blocks at bs {BLOCK_SIZE}")
    for rows, iters in COMPUTE:
        x_host = torch.zeros((rows, LANES), dtype=torch.int32)
        x = x_host.to(dev)
        kernel_s = common.event_seconds(lambda: hopper_probes.mix_rounds(x, iters), reps=10)
        t = common.host_seconds(lambda: hopper_probes.mix_rounds(x_host.to(dev), iters).cpu())
        ops = 3 * iters * rows * LANES
        out.append({"kind": "compute", "rows": rows, "iters": iters, "ops": ops, "t_s": t, "kernel_s": kernel_s,
                    "int32_ops_per_s": ops / kernel_s})
    for rec in out:
        rec["card"] = card
    return out


if __name__ == "__main__":
    sys.exit(common.main("transfer_probe", run, __doc__.splitlines()[0]))
