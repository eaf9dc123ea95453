"""The card's rates against its datasheet: matrix unit, device memory, a dependent integer chain, a dependent gather.

The counterpart of the JAX package's ``scripts/hw_probe.py``, which asked
how far a TPU's matrix unit, memory and vector unit reach their peaks, and
what a dependent gather costs against a dependent elementwise op. Here, each
timed by CUDA events on the card:

- ``matmul 2048^3 bf16``: ``torch.matmul`` of two (2048, 2048) bf16 matrices
  (the JAX script leaves it to XLA outside any kernel), in TFLOP/s against
  the datasheet's 989 dense;
- ``triad 64MB f32``: ``y + 1.0000001 * x`` over 16M float32 (one pass:
  two reads and a write of 64 MB), in GB/s against the datasheet's 3350;
- ``dependent chain (8,128) x1M``: the multiply-xor-shift recurrence a
  million rounds on an int32 (8, 128) plane of ones through
  ``hopper_probes.mix_rounds``: 1024 independent chains on 4 SMs, so the
  time per round is the latency of three dependent integer ops;
- ``gather chain (128,128) x10K`` and ``elementwise chain (128,128) x10K``:
  ``hopper_probes.gather_chain`` and ``ew_chain`` on the JAX script's own
  inputs (``arange(16384).reshape(128, 128)`` and
  ``RandomState(0).randint(0, 128, (128, 128))``), spread over the card as
  the TPU kernels held its whole chip: the gather one warp a row, each row
  its own CTA on its own SM, the row in shared memory; the elementwise chain
  one element a thread over 128 CTAs. Each step is then one dependent
  latency, and their ratio per step is the card's cost of a dependent
  random shared-memory access against a dependent integer add and xor.

The JAX script's K-slope and per-dispatch readback existed for a TPU behind
a slow link; CUDA events time the card alone.

    python -m pim_compression_tpu_torch.scripts.hw_probe

writes ``build/probes/hw_probe.json``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pim_compression_tpu_torch.ops import hopper_probes
from pim_compression_tpu_torch.scripts import common

N = 2048
M = 16 * 1024 * 1024  # float32 elements: 64 MB
CHAIN_ROUNDS = 1_000_000
GATHER_STEPS = 10_000


def gather_inputs(dev) -> tuple[torch.Tensor, torch.Tensor]:
    """hw_probe.py:149-154's planes: x = arange(16384) as (128, 128), idx
    seeded in [0, 128)."""
    x = torch.arange(128 * 128, dtype=torch.int32).reshape(128, 128)
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (128, 128)).astype(np.int32))
    return x.to(dev), idx.to(dev)


def run(device="cuda:0") -> list[dict]:
    """Every record of the probe, measured on ``device`` (a CUDA device)."""
    dev = common.cuda_device(device)
    common.warm(dev)
    card = common.card(dev)
    out = []

    gen = torch.Generator(device=dev)
    a = torch.randn((N, N), generator=gen.manual_seed(0), device=dev, dtype=torch.bfloat16)
    b = torch.randn((N, N), generator=gen.manual_seed(1), device=dev, dtype=torch.bfloat16)
    c = torch.empty_like(a)
    per = common.event_seconds(lambda: torch.matmul(a, b, out=c), reps=50, warmup=5)
    rate = 2 * N**3 / per
    out.append({"probe": "matmul 2048^3 bf16", "per_call_s": per, "achieved_tflops": rate / 1e12,
                "peak": common.PEAK_BF16_FLOPS / 1e12, "fraction_of_peak": rate / common.PEAK_BF16_FLOPS,
                "peak_source": common.DATASHEET})
    del a, b, c

    bufs = [torch.ones(M, dtype=torch.float32, device=dev), torch.empty(M, dtype=torch.float32, device=dev)]
    y = torch.full((M,), 1e-6, dtype=torch.float32, device=dev)

    def triad():
        torch.add(y, bufs[0], alpha=1.0000001, out=bufs[1])
        bufs.reverse()

    per = common.event_seconds(triad, reps=50, warmup=5)
    rate = 3 * M * 4 / per
    out.append({"probe": "triad 64MB f32", "per_call_s": per, "achieved_gbps": rate / 1e9,
                "peak": common.PEAK_HBM_BYTES / 1e9, "fraction_of_peak": rate / common.PEAK_HBM_BYTES,
                "peak_source": common.DATASHEET})
    del bufs, y

    v = torch.ones((8, hopper_probes.LANES), dtype=torch.int32, device=dev)
    per = common.event_seconds(lambda: hopper_probes.mix_rounds(v, CHAIN_ROUNDS), reps=3)
    out.append({"probe": "dependent chain (8,128) x1M", "per_call_s": per, "round_s": per / CHAIN_ROUNDS,
                "op_s": per / (3 * CHAIN_ROUNDS), "int32_ops_per_s": 3 * CHAIN_ROUNDS * v.numel() / per})

    x, idx = gather_inputs(dev)
    steps = {}
    for name, fn in (("gather", hopper_probes.gather_chain), ("elementwise", hopper_probes.ew_chain)):
        per = common.event_seconds(lambda: fn(x, idx, GATHER_STEPS), reps=5)
        steps[name] = per / GATHER_STEPS
        out.append({"probe": f"{name} chain (128,128) x10K", "per_call_s": per, "step_s": steps[name],
                    "plane_steps_per_s": GATHER_STEPS / per,
                    "int32_ops_per_s": 2 * x.numel() * GATHER_STEPS / per})
    out.append({"probe": "gather over elementwise", "gather_cost_s": steps["gather"] - steps["elementwise"],
                "ratio": steps["gather"] / steps["elementwise"]})
    for rec in out:
        rec["card"] = card
    return out


if __name__ == "__main__":
    sys.exit(common.main("hw_probe", run, __doc__.splitlines()[0]))
