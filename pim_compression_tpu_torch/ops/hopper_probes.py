"""Hardware probes: the Hopper kernels' wrappers and their plain PyTorch versions.

The counterparts of the JAX package's TPU probe kernels, in
``csrc/probes.cu``:

- ``gather_chain``: ``scripts/hw_probe.py::gather_kernel``, ``x <-
  take_along_axis(x, idx, axis=1) ^ 1`` on an int32 (128, 128) plane,
  ``iters`` times; returns rows 0:8 of the final plane.
- ``ew_chain``: ``scripts/hw_probe.py::ew_kernel``, ``x <- (x + idx) ^ 1``
  on the same shapes.
- ``copy_rows``: ``scripts/transfer_probe.py::kern_copy``, ``x[0:out_rows] +
  1`` when ``out_rows <= in_rows``, else row 0 of x broadcast to
  ``out_rows`` rows without the + 1 (the broadcast lambda at
  ``transfer_probe.py:73-74``).
- ``mix_rounds``: ``scripts/transfer_probe.py::kern_compute``, ``v <- (v *
  -1640531527) ^ (v >> 3)`` ``iters`` times over an int32 (rows, 128) plane,
  folded to (8, 128) by ``out[s, l] = sum over g of v[8g + s, l]``
  (wrapping int32).
- ``chain_fold``: ``scripts/emu_calibrate.py::chain_kernel``, the same
  recurrence ``iterate`` times from ``v0[r, l] = x[0, l] + r`` over (rows,
  128), folded as ``mix_rounds`` folds.

Each wrapper checks type (int32), shape, contiguity and device, sends a CPU
tensor to its plain version and a CUDA tensor to its kernel, and raises on
anything else. The arithmetic is integer-only, so kernel and plain version
agree exactly. ``LAUNCHES`` counts each wrapper's kernel launches.
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.ops import _build

LANES = 128
PLANE_ROWS = 128  # the chains' plane: hw_probe.py:149-154
MUL = -1640531527  # 0x9E3779B9 as int32

# Kernel launches since import (or since a caller reset them), one count per
# wrapper. A wrapper adds one per launch and nowhere else, so a run can show
# that each kernel ran.
LAUNCHES = {"gather_chain": 0, "ew_chain": 0, "copy_rows": 0, "mix_rounds": 0, "chain_fold": 0}


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    """int32, 2-D with 128 columns, contiguous, one CPU or CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise ValueError(f"{name} takes int32 tensors, not {t.dtype}")
        if t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"{name} takes (rows, {LANES}) tensors, not {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{name} needs its tensors on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {dev}")
    return dev


def _check_steps(name: str, steps: int) -> None:
    if not 0 <= steps < 2**31:
        raise ValueError(f"{name}: steps must be in [0, 2**31), not {steps}")


def _launch(name: str, dev: torch.device, entry: str, *args) -> None:
    lib = _build.load()
    rc = getattr(lib, entry)(
        *args, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check_plane(name: str, x: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.device:
    dev = _check(name, x, idx)
    if x.shape[0] != PLANE_ROWS or idx.shape[0] != PLANE_ROWS:
        raise ValueError(f"{name} takes ({PLANE_ROWS}, {LANES}) planes")
    _check_steps(name, iters)
    return dev


def gather_chain_torch(x: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` times ``x <- gather(x, 1, idx) ^ 1``; rows 0:8 of the result."""
    idx = idx.long()
    for _ in range(iters):
        x = torch.gather(x, 1, idx) ^ 1
    return x[0:8].clone()


def gather_chain(x: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.Tensor:
    """The dependent gather chain: x and idx int32 (128, 128), idx in [0,
    128) (the plain version raises outside it, the kernel reads idx & 127);
    returns int32 (8, 128), rows 0:8 of the final plane. The kernel writes
    the whole plane; the result is a view of its first 8 rows."""
    dev = _check_plane("gather_chain", x, idx, iters)
    if dev.type == "cpu":
        return gather_chain_torch(x, idx, iters)
    out = torch.empty((PLANE_ROWS, LANES), dtype=torch.int32, device=dev)
    _launch("gather_chain", dev, "pim_probe_gather_chain", x.data_ptr(), idx.data_ptr(), out.data_ptr(), iters)
    return out[0:8]


def ew_chain_torch(x: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` times ``x <- (x + idx) ^ 1`` (wrapping int32); rows 0:8."""
    for _ in range(iters):
        x = (x + idx) ^ 1
    return x[0:8].clone()


def ew_chain(x: torch.Tensor, idx: torch.Tensor, iters: int) -> torch.Tensor:
    """The elementwise chain on the gather chain's shapes; int32 (8, 128)."""
    dev = _check_plane("ew_chain", x, idx, iters)
    if dev.type == "cpu":
        return ew_chain_torch(x, idx, iters)
    out = torch.empty((PLANE_ROWS, LANES), dtype=torch.int32, device=dev)
    _launch("ew_chain", dev, "pim_probe_ew_chain", x.data_ptr(), idx.data_ptr(), out.data_ptr(), iters)
    return out[0:8]


def copy_rows_torch(x: torch.Tensor, out_rows: int) -> torch.Tensor:
    if out_rows <= x.shape[0]:
        return x[0:out_rows] + 1
    return x[0:1].expand(out_rows, LANES).clone()


def copy_rows(x: torch.Tensor, out_rows: int) -> torch.Tensor:
    """int32 (in_rows, 128) -> int32 (out_rows, 128): ``x[0:out_rows] + 1``
    (wrapping) when ``out_rows <= in_rows``, else row 0 of x in every row."""
    dev = _check("copy_rows", x)
    if x.shape[0] == 0 or not 0 <= out_rows < 2**31 // LANES:
        raise ValueError(f"copy_rows: {x.shape[0]} input rows and {out_rows} output rows")
    if dev.type == "cpu":
        return copy_rows_torch(x, out_rows)
    out = torch.empty((out_rows, LANES), dtype=torch.int32, device=dev)
    _launch("copy_rows", dev, "pim_probe_copy_rows", x.data_ptr(), out.data_ptr(), x.shape[0], out_rows)
    return out


def _mix(v: torch.Tensor, steps: int) -> torch.Tensor:
    for _ in range(steps):
        v = (v * MUL) ^ (v >> 3)  # wrapping int32 multiply; arithmetic shift
    return v


def _fold(v: torch.Tensor) -> torch.Tensor:
    """(rows, 128) -> (8, 128): the sum over row groups, wrapped to int32."""
    s = v.reshape(-1, 8, LANES).sum(dim=0, dtype=torch.int64)
    return (((s + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _check_fold(name: str, rows: int, steps: int) -> None:
    if rows <= 0 or rows % 8 or rows * LANES >= 2**31:
        raise ValueError(f"{name}: rows must be a positive multiple of 8, not {rows}")
    _check_steps(name, steps)


def mix_rounds_torch(x: torch.Tensor, iters: int) -> torch.Tensor:
    return _fold(_mix(x, iters))


def mix_rounds(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The recurrence ``iters`` times over x int32 (rows, 128), rows % 8 ==
    0, folded to int32 (8, 128)."""
    dev = _check("mix_rounds", x)
    _check_fold("mix_rounds", x.shape[0], iters)
    if dev.type == "cpu":
        return mix_rounds_torch(x, iters)
    out = torch.zeros((8, LANES), dtype=torch.int32, device=dev)
    _launch("mix_rounds", dev, "pim_probe_mix_rounds", x.data_ptr(), out.data_ptr(), x.shape[0], iters, 0)
    return out


def chain_fold_torch(x: torch.Tensor, rows: int, iterate: int) -> torch.Tensor:
    rows_iota = torch.arange(rows, dtype=torch.int32, device=x.device)[:, None]
    return _fold(_mix(x[0:1].expand(rows, LANES) + rows_iota, iterate))


def chain_fold(x: torch.Tensor, rows: int, iterate: int) -> torch.Tensor:
    """The recurrence ``iterate`` times from ``v0[r, l] = x[0, l] + r`` over
    (rows, 128), rows % 8 == 0, folded to int32 (8, 128); x int32 (>= 1,
    128), of which row 0 is read."""
    dev = _check("chain_fold", x)
    _check_fold("chain_fold", rows, iterate)
    if x.shape[0] == 0:
        raise ValueError("chain_fold needs a row to start from")
    if dev.type == "cpu":
        return chain_fold_torch(x, rows, iterate)
    out = torch.zeros((8, LANES), dtype=torch.int32, device=dev)
    _launch("chain_fold", dev, "pim_probe_mix_rounds", x.data_ptr(), out.data_ptr(), rows, iterate, 1)
    return out
