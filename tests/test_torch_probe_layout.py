"""The chain probes' layouts on the card, mirrored on the CPU.

``csrc/probes.cu`` spreads both chains over the card's SMs:

- ``gather_chain_kernel``: one CTA of one warp a row; lane ``c & 31`` owns
  column ``c`` in slot ``c >> 5``, keeps ``idx[r, c] & 127`` in a register,
  and a step reads one of two shared-memory slices of the row and writes
  the other, then syncs the warp;
- ``ew_chain_kernel``: one element a thread, CTA ``b`` thread ``t`` on
  element ``b * kEwThreads + t``.

The models below are plain torch written in those terms: the grid and the
CTA's threads come from the kernel's launch lines and constants, read out
of the source, and a gather step reads one slice and writes the other,
as the kernel's does. Each model is held against the JAX
package's ``gather_kernel`` / ``ew_kernel`` in interpret mode (as
``test_torch_probes.py`` runs them) and against ``gather_chain_torch`` /
``ew_chain_torch``, exactly.
"""

from __future__ import annotations

import functools
import pathlib
import re

import numpy as np
import pytest
import torch
from test_torch_cuda import CHAIN_INDEX
from test_torch_probes import HW, _interpret, _plane_inputs, _script_function

from pim_compression_tpu_torch.ops import hopper_probes

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

PROBES_CU = pathlib.Path(hopper_probes.__file__).resolve().parent.parent / "csrc" / "probes.cu"
SRC = PROBES_CU.read_text()
CONSTS = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", SRC)}
WARP = 32


def _int(expr: str) -> int:
    """A C integer expression of the source's constants."""
    return eval(expr.replace("/", "//"), {}, dict(CONSTS))


CONSTS["kColsPerLane"] = _int(re.search(r"constexpr int kColsPerLane = ([^;]+);", SRC).group(1))


def _launch(kernel: str) -> tuple[int, int, int]:
    """(CTAs, threads a CTA, dynamic shared bytes) of the kernel's launch in probes.cu."""
    m = re.search(kernel + r"<<<([^,]+),\s*([^,]+),\s*([^,]+),", SRC)
    return tuple(_int(g) for g in m.groups())


GATHER_GRID = _launch("gather_chain_kernel")
EW_GRID = _launch("ew_chain_kernel")


def gather_layout(x: torch.Tensor, idx: torch.Tensor, steps: int) -> torch.Tensor:
    """gather_chain_kernel on the CPU; every CTA (row) and every lane of its
    warp at once, a step at a time."""
    ctas, threads, _ = GATHER_GRID
    lanes, cols_per_lane = CONSTS["kLanes"], CONSTS["kColsPerLane"]
    rows = torch.arange(ctas)
    # cols[l, j] = l + 32 j: lane c & 31, slot c >> 5.
    cols = torch.arange(threads)[:, None] + WARP * torch.arange(cols_per_lane)[None, :]
    slices = torch.zeros((ctas, 2, lanes), dtype=torch.int32)
    slices[:, 0, :] = x[rows]  # each lane stores its own columns
    src = (idx[rows][:, cols] & (lanes - 1)).long()  # (ctas, lane, slot), in registers for the whole loop
    for it in range(steps):
        # Read slice it & 1, write the other; __syncwarp: the next step reads it whole.
        g = torch.gather(slices[:, it & 1, :], 1, src.reshape(ctas, -1))
        slices[:, (it & 1) ^ 1, cols.reshape(-1)] = g ^ 1
    out = torch.empty_like(x)
    out[rows] = slices[:, steps & 1, :]
    return out[0:8].clone()


def ew_layout(x: torch.Tensor, idx: torch.Tensor, steps: int) -> torch.Tensor:
    """ew_chain_kernel on the CPU: every thread's chain in one vector, thread
    t of CTA b on element b * kEwThreads + t."""
    ctas, threads, _ = EW_GRID
    at = (torch.arange(ctas)[:, None] * CONSTS["kEwThreads"] + torch.arange(threads)[None, :]).reshape(-1)
    v, i = x.reshape(-1)[at], idx.reshape(-1)[at]
    for _ in range(steps):
        v = (v + i) ^ 1  # wrapping int32, as the kernel's uint32
    out = torch.empty(x.numel(), dtype=torch.int32)
    out[at] = v
    return out.reshape(x.shape)[0:8].clone()


MODELS = {"gather": (gather_layout, hopper_probes.gather_chain_torch),
          "ew": (ew_layout, hopper_probes.ew_chain_torch)}


def test_layouts_cover_the_plane_once_and_spread_over_sms():
    rows, lanes = CONSTS["kPlaneRows"], CONSTS["kLanes"]
    ctas, threads, shared = GATHER_GRID
    assert (ctas, threads, shared) == (rows, WARP, 0)  # a warp a row, a row a CTA
    cols = (torch.arange(threads)[:, None] + WARP * torch.arange(CONSTS["kColsPerLane"])[None, :]).reshape(-1)
    assert torch.equal(cols.sort().values, torch.arange(lanes))
    assert torch.equal(cols & (WARP - 1), torch.arange(threads).repeat_interleave(CONSTS["kColsPerLane"]))
    ctas, threads, shared = EW_GRID
    assert ctas * threads == rows * lanes and shared == 0 and ctas > 1
    at = (torch.arange(ctas)[:, None] * CONSTS["kEwThreads"] + torch.arange(threads)[None, :]).reshape(-1)
    assert torch.equal(at.sort().values, torch.arange(rows * lanes))
    # Nothing across CTAs: neither kernel holds a block-wide barrier.
    for kernel in ("gather_chain_kernel", "ew_chain_kernel"):
        body = SRC.split(kernel + "(")[1].split("\n}\n")[0]
        assert "__syncthreads" not in body and "atomic" not in body


@pytest.mark.parametrize("steps", [1, 7, 40])
@pytest.mark.parametrize("inputs", ["hw-probe", "seeded"])
@pytest.mark.parametrize("name", ["gather", "ew"])
def test_layout_equals_the_tpu_kernel_and_the_plain_version(name, inputs, steps):
    x, idx = _plane_inputs(inputs)
    want = _interpret(functools.partial(_script_function(HW, f"{name}_kernel"), iters=steps), 8, x, idx)
    model, plain = MODELS[name]
    got = model(torch.from_numpy(x), torch.from_numpy(idx), steps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, plain(torch.from_numpy(x), torch.from_numpy(idx), steps))


@pytest.mark.parametrize("steps", [0, 2, 9])
@pytest.mark.parametrize("index", list(CHAIN_INDEX))
@pytest.mark.parametrize("name", ["gather", "ew"])
def test_layout_on_the_card_tests_index_planes(name, index, steps):
    rng = np.random.default_rng(steps)
    x, _ = _plane_inputs("seeded")
    idx = torch.from_numpy(CHAIN_INDEX[index](rng).astype(np.int32))
    model, plain = MODELS[name]
    got = model(torch.from_numpy(x), idx, steps)
    assert torch.equal(got, plain(torch.from_numpy(x), idx & 127 if name == "gather" else idx, steps))
