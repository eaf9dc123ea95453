"""A cost model of a dependent integer op on the card, fitted to kernels of known op counts.

The counterpart of the JAX package's ``scripts/emu_calibrate.py``, which
fitted ``t = t0 + c_op * n_ops + c_vreg * vreg_ops`` to chain kernels on a
TPU. Here the same chain (``hopper_probes.chain_fold``: the
multiply-xor-shift recurrence ``iterate`` times from ``v0[r, l] = x[0, l] +
r`` over (rows, 128), folded to (8, 128)) runs at the same nine (rows,
iterate) points, timed by CUDA events, and is fitted as

    t = t0 + c_op * n_ops + c_lane * lane_ops

with counts exact by construction: ``n_ops = 3 * iterate`` (the dependent
ops of one chain) and ``lane_ops = 3 * iterate * rows * 128`` (all of them).
At 8 rows (1024 threads on 4 SMs) the time follows the chain's latency,
``c_op``; at 8192 rows (a million threads on every SM) it follows integer
issue, ``c_lane``, whose inverse is the card's measured int32 rate.

    python -m pim_compression_tpu_torch.scripts.emu_calibrate

writes ``build/probes/emu_calibrate.json``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pim_compression_tpu_torch.ops import hopper_probes
from pim_compression_tpu_torch.scripts import common

LANES = hopper_probes.LANES
# emu_calibrate.py:119-123: the op axis at 8 rows, the lane axis at 1024 and 8192.
POINTS = [
    (8, 2_000), (8, 100_000), (8, 400_000), (8, 1_600_000),
    (1024, 2_000), (1024, 100_000),
    (8192, 1_000), (8192, 12_000), (8192, 50_000),
]
MODEL = "t = t0 + c_op * n_ops + c_lane * lane_ops"


def counts(rows: int, iterate: int) -> dict:
    """The exact op counts of one chain_fold call (the fold's adds aside)."""
    return {"n_ops": 3 * iterate, "lane_ops": 3 * iterate * rows * LANES}


def fit(points: list[dict]) -> dict:
    """Least squares of ``MODEL`` over points with ``n_ops``, ``lane_ops``
    and ``measured_s``; adds each point's ``predicted_s`` and
    ``residual_x`` (measured / predicted)."""
    a = np.array([[1.0, p["n_ops"], p["lane_ops"]] for p in points])
    t = np.array([p["measured_s"] for p in points])
    scale = np.abs(a).max(axis=0)  # the columns span ten orders of magnitude
    t0, c_op, c_lane = (float(c) for c in np.linalg.lstsq(a / scale, t, rcond=None)[0] / scale)
    for p in points:
        pred = t0 + c_op * p["n_ops"] + c_lane * p["lane_ops"]
        p["predicted_s"] = pred
        p["residual_x"] = p["measured_s"] / pred if pred > 0 else None
    return {"model": MODEL, "t0_s": t0, "c_op_s": c_op, "c_lane_s": c_lane, "points": points}


def run(device="cuda:0") -> dict:
    """The nine points measured on ``device`` (a CUDA device) and their fit."""
    dev = common.cuda_device(device)
    common.warm(dev)
    x = torch.zeros((8, LANES), dtype=torch.int32, device=dev)
    points = []
    for rows, iterate in POINTS:
        t = common.event_seconds(lambda: hopper_probes.chain_fold(x, rows, iterate), reps=3)
        points.append({"rows": rows, "iterate": iterate, **counts(rows, iterate), "measured_s": t})
    out = fit(points)
    out["card"] = common.card(dev)
    out["int32_ops_per_s"] = 1.0 / out["c_lane_s"] if out["c_lane_s"] > 0 else None
    return out


if __name__ == "__main__":
    sys.exit(common.main("emu_calibrate", run, __doc__.splitlines()[0]))
