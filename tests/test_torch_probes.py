"""The port's hardware probes against the JAX package's TPU probe kernels.

Each probe kernel of ``scripts/hw_probe.py``, ``scripts/transfer_probe.py``
and ``scripts/emu_calibrate.py`` runs here in interpret mode
(``pl.pallas_call(..., interpret=True)`` with the scripts' own VMEM
BlockSpecs), taken from its file with ``ast`` so that the test follows the
file; the port's wrappers in ``ops/hopper_probes.py`` run their plain
PyTorch versions on the same seeded numpy inputs, as CPU tensors. The
results must be equal exactly: the probes are integer-only. Also: the
wrappers' refusals, the cost model's fit, and the scripts refusing to
measure without a CUDA device. The kernels themselves are held against the
plain versions on the card in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pim_compression_tpu_torch.ops import hopper_probes
from pim_compression_tpu_torch.scripts import common, emu_calibrate, hw_probe, match_time, match_variants, transfer_probe

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

SCRIPTS = pathlib.Path(__file__).resolve().parent.parent / "scripts"
HW, TRANSFER, EMU = (SCRIPTS / f"{n}.py" for n in ("hw_probe", "transfer_probe", "emu_calibrate"))
LANES = 128
INT32 = np.iinfo(np.int32)


def _script_function(path: pathlib.Path, name: str):
    """The function ``name`` of a script, found at any depth (``gather_kernel``
    and ``ew_kernel`` are nested in ``main``), compiled alone with the
    script's module-level names it reads. The script's own module code (its
    environment settings, its imports) does not run."""
    tree = ast.parse(path.read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"jax": jax, "jnp": jnp, "LANES": LANES, "SUBLANES": 8}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), ns)
    return ns[name]


def _broadcast_kernel(out_rows: int):
    """transfer_probe.py:73-74: the inline kernel for more output rows than input rows."""
    tree = ast.parse(TRANSFER.read_text())
    lam = next(
        n for n in ast.walk(tree)
        if isinstance(n, ast.Lambda) and [a.arg for a in n.args.args] == ["x_ref", "o_ref"]
    )
    return eval(compile(ast.Expression(body=lam), str(TRANSFER), "eval"),
                {"jnp": jnp, "LANES": LANES, "out_rows": out_rows})


def _interpret(kernel, out_rows: int, *inputs: np.ndarray) -> np.ndarray:
    """The TPU kernel as the scripts call it (every operand whole in VMEM), interpreted."""
    fn = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(inputs),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((out_rows, LANES), jnp.int32),
        interpret=True,
    )
    return np.asarray(fn(*inputs))


def _int32(rng: np.random.Generator, shape) -> np.ndarray:
    """Seeded int32 values over the whole range, negatives and both ends included."""
    x = rng.integers(INT32.min, INT32.max, shape, dtype=np.int64, endpoint=True).astype(np.int32)
    x.reshape(-1)[:4] = [INT32.min, INT32.max, -1, 0]
    return x


def _plane_inputs(which: str) -> tuple[np.ndarray, np.ndarray]:
    if which == "hw-probe":  # hw_probe.py:149-154, as hw_probe.gather_inputs restates them
        x, idx = hw_probe.gather_inputs("cpu")
        return x.numpy(), idx.numpy()
    rng = np.random.default_rng(131)
    return _int32(rng, (128, 128)), rng.integers(0, 128, (128, 128)).astype(np.int32)


def _launches() -> dict:
    return dict(hopper_probes.LAUNCHES)


@pytest.mark.parametrize("steps", [1, 7, 40])
@pytest.mark.parametrize("inputs", ["hw-probe", "seeded"])
@pytest.mark.parametrize("name", ["gather", "ew"])
def test_chains_equal_the_tpu_kernels(name, inputs, steps):
    x, idx = _plane_inputs(inputs)
    kernel = _script_function(HW, f"{name}_kernel")
    want = _interpret(functools.partial(kernel, iters=steps), 8, x, idx)
    launches = _launches()
    wrapper = hopper_probes.gather_chain if name == "gather" else hopper_probes.ew_chain
    got = wrapper(torch.from_numpy(x), torch.from_numpy(idx), steps)
    assert got.dtype == torch.int32 and got.shape == (8, LANES)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _launches() == launches  # the CPU runs no kernel


@pytest.mark.parametrize("in_rows, out_rows", [(8, 8), (64, 8), (8, 64), (64, 64)])
def test_copy_equals_the_tpu_kernel(in_rows, out_rows):
    x = _int32(np.random.default_rng(in_rows * 1000 + out_rows), (in_rows, LANES))
    if out_rows <= in_rows:
        kernel = functools.partial(_script_function(TRANSFER, "kern_copy"), out_rows=out_rows)
    else:
        kernel = _broadcast_kernel(out_rows)
    want = _interpret(kernel, out_rows, x)
    launches = _launches()
    got = hopper_probes.copy_rows(torch.from_numpy(x), out_rows)
    assert got.shape == (out_rows, LANES)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _launches() == launches
    if out_rows > in_rows:  # the broadcast adds nothing
        np.testing.assert_array_equal(want, np.broadcast_to(x[0:1], want.shape))


@pytest.mark.parametrize("steps", [0, 1, 13, 100])
@pytest.mark.parametrize("rows", [8, 64])
def test_compute_equals_the_tpu_kernel(rows, steps):
    x = _int32(np.random.default_rng(rows + steps), (rows, LANES))
    kernel = functools.partial(_script_function(TRANSFER, "kern_compute"), iters=steps)
    want = _interpret(kernel, 8, x)
    launches = _launches()
    got = hopper_probes.mix_rounds(torch.from_numpy(x), steps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _launches() == launches


@pytest.mark.parametrize("steps", [0, 1, 13, 100])
@pytest.mark.parametrize("rows", [8, 64])
def test_chain_equals_the_tpu_kernel(rows, steps):
    x = _int32(np.random.default_rng(7 * rows + steps), (8, LANES))
    kernel = functools.partial(_script_function(EMU, "chain_kernel"), iterate=steps, rows=rows)
    want = _interpret(kernel, 8, x)
    launches = _launches()
    got = hopper_probes.chain_fold(torch.from_numpy(x), rows, steps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert _launches() == launches


def test_chain_from_row0_is_mix_rounds_of_its_start_plane():
    # Rows 16 and 17 share one kernel: chain_fold is mix_rounds of the plane
    # x[0, l] + r, on the plain path as on the card.
    x = torch.from_numpy(_int32(np.random.default_rng(5), (8, LANES)))
    start = x[0:1].expand(24, LANES) + torch.arange(24, dtype=torch.int32)[:, None]
    assert torch.equal(hopper_probes.chain_fold(x, 24, 9), hopper_probes.mix_rounds(start.contiguous(), 9))


PLANE = torch.zeros((128, 128), dtype=torch.int32)
ROWS = torch.zeros((16, 128), dtype=torch.int32)
REFUSED = {
    "gather-int64": lambda: hopper_probes.gather_chain(PLANE.long(), PLANE, 1),
    "gather-shape": lambda: hopper_probes.gather_chain(ROWS, ROWS, 1),
    "gather-not-contiguous": lambda: hopper_probes.gather_chain(PLANE.t(), PLANE, 1),
    "gather-negative-steps": lambda: hopper_probes.gather_chain(PLANE, PLANE, -1),
    "ew-meta-device": lambda: hopper_probes.ew_chain(PLANE.to("meta"), PLANE.to("meta"), 1),
    "ew-width": lambda: hopper_probes.ew_chain(torch.zeros((128, 64), dtype=torch.int32), PLANE, 1),
    "copy-no-rows": lambda: hopper_probes.copy_rows(ROWS[:0], 8),
    "copy-negative-rows": lambda: hopper_probes.copy_rows(ROWS, -1),
    "copy-1d": lambda: hopper_probes.copy_rows(ROWS.reshape(-1), 8),
    "mix-rows-not-multiple-of-8": lambda: hopper_probes.mix_rounds(ROWS[:12].contiguous(), 1),
    "mix-float": lambda: hopper_probes.mix_rounds(ROWS.float(), 1),
    "chain-rows-not-multiple-of-8": lambda: hopper_probes.chain_fold(ROWS, 20, 1),
    "chain-no-start-row": lambda: hopper_probes.chain_fold(ROWS[:0], 8, 1),
    "chain-negative-steps": lambda: hopper_probes.chain_fold(ROWS, 8, -3),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    launches = _launches()
    with pytest.raises(ValueError):
        REFUSED[case]()
    assert _launches() == launches


def test_plain_gather_refuses_an_index_out_of_range():
    with pytest.raises(RuntimeError):
        hopper_probes.gather_chain(PLANE, torch.full((128, 128), 128, dtype=torch.int32), 1)


def test_fit_recovers_known_costs():
    t0, c_op, c_lane = 4e-6, 2.5e-9, 6e-14
    points = [
        {"rows": r, "iterate": i, **emu_calibrate.counts(r, i)} for r, i in emu_calibrate.POINTS
    ]
    for p in points:
        p["measured_s"] = t0 + c_op * p["n_ops"] + c_lane * p["lane_ops"]
    got = emu_calibrate.fit(points)
    assert got["model"] == emu_calibrate.MODEL
    assert got["t0_s"] == pytest.approx(t0, rel=1e-6)
    assert got["c_op_s"] == pytest.approx(c_op, rel=1e-6)
    assert got["c_lane_s"] == pytest.approx(c_lane, rel=1e-6)
    assert all(p["residual_x"] == pytest.approx(1.0, rel=1e-9) for p in got["points"])
    assert emu_calibrate.counts(8192, 50_000) == {"n_ops": 150_000, "lane_ops": 157_286_400_000}


def test_copy_bytes_count_what_the_copy_moves():
    assert transfer_probe.copy_bytes(32768, 32768) == 2 * 32768 * 512
    assert transfer_probe.copy_bytes(4096, 8) == 2 * 8 * 512
    assert transfer_probe.copy_bytes(8, 32768) == (1 + 32768) * 512  # the broadcast reads one row


@pytest.mark.parametrize(
    "script", [transfer_probe, hw_probe, emu_calibrate, match_time, match_variants],
    ids=lambda m: m.__name__.rsplit(".")[-1],
)
def test_scripts_refuse_without_a_gpu_and_write_nothing(script, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(common, "OUT_DIR", tmp_path / "probes")
    launches = _launches()
    with pytest.raises(RuntimeError, match="CUDA device"):
        script.run("cuda:0")
    with pytest.raises(ValueError, match="CUDA device"):  # and never on the CPU
        script.run("cpu")
    name = script.__name__.rsplit(".", 1)[-1]
    with pytest.raises(RuntimeError, match="CUDA device"):
        common.main(name, script.run, "probe", [])
    assert not (tmp_path / "probes").exists()
    assert _launches() == launches
