"""Whole runs of a tiny cell on the CPU, past the look for a card: a sound
run is correct; the control and every planted fault are not. And nothing
the harness imports is JAX or the JAX package."""

from __future__ import annotations

import ast
import pathlib
import random
import subprocess
import sys
import time

import pytest
import torch

from hopper_bench import controls
from hopper_bench.core import cells, faults, harness
from hopper_bench.tests.bench_tiny import make_bench, tiny_cell


class InProcess:
    """What ``controls.control_entry`` asks of a pool."""

    @staticmethod
    def map(fn, tasks):
        return [fn(t) for t in tasks]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return make_bench(tmp_path_factory.mktemp("bench"))


def _run(bench, entry, seed, wrap=None, traced=False):
    cell = tiny_cell(bench, entry)
    result, code = harness.run_cell(cell, seed, 60.0, traced, torch.device("cpu"), time.perf_counter(),
                                    entry_wrap=wrap, calls=4, log=lambda msg: None)
    assert code == 0
    return result


@pytest.mark.parametrize("entry", ["decompress", "compress"])
def test_a_sound_run_is_correct(bench, entry):
    result = _run(bench, entry, 2**31 + 11)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 4
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in result["checks"].values())
    names = {"decompress": {"decompress_gbps", "setup_s"}, "compress": {"compress_gbps", "compress_ratio", "setup_s"}}
    assert set(result["metrics"]) == names[entry]
    if entry == "compress":
        assert result["metrics"]["compress_ratio"]["value"] > 1.0


def test_a_traced_run_reads_the_host_span(bench):
    result = _run(bench, "compress", 5, traced=True)
    assert result["correct"]
    assert set(result["metrics"]) == {"enqueue_ms.compress"}  # no device on the CPU: no device metric


@pytest.mark.parametrize("entry", ["decompress", "compress"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(bench, entry, fault):
    result = _run(bench, entry, 77, wrap=faults.FAULTS[fault])
    assert not result["correct"] and result["failed"] > 0


def _kept_call(seed: int, calls: int) -> int:
    """The call a reservoir of one keeps, as the driver draws it."""
    draw, kept = random.Random(seed).randrange, 0
    for i in range(1, calls):
        if draw(i + 1) < 1:
            kept = i
    return kept


def test_a_size_that_another_call_gives_otherwise_is_not_correct(bench, monkeypatch):
    # One answer kept (a reservoir of one) out of two passes over the 4
    # batches; the second pass reports one block's size one byte long. The
    # kept answer is of the first pass and sound, so only the sizes that the
    # window summed can show the fault.
    cell = tiny_cell(bench, "compress")
    module = cells.load_driver(cell)
    monkeypatch.setattr(module, "CHECK_BYTES", 4 * 1024)
    seed = next(s for s in range(100, 200) if _kept_call(s, 8) < 4)

    def wrap(kind, entry):
        count = [0]

        def call(*args):
            rows, sizes = entry(*args)
            count[0] += 1
            if count[0] > 4:
                sizes = sizes.clone()
                sizes[1] += 1
            return rows, sizes

        return call

    for fault, correct in ((None, True), (wrap, False)):
        result, code = harness.run_cell(cell, seed, 60.0, False, torch.device("cpu"), time.perf_counter(),
                                        entry_wrap=fault, calls=8, log=lambda msg: None)
        assert code == 0 and result["attempted"] == 8
        assert result["correct"] is correct
        assert result["checks"]["bad_blocks"]["value"] == (0 if correct else 1)


@pytest.mark.parametrize("entry", ["decompress", "compress"])
def test_the_control_is_not_correct(bench, entry):
    cell = tiny_cell(bench, entry)
    cap = (32 + 1024 + 1024 // 6 + 127) // 128 * 128  # the port's padded row for 1 KB blocks

    def wrap(kind, _entry):
        return controls.control_entry(kind, InProcess, cap, cell.config["codec"]["block_size"])

    result = _run(bench, entry, 78, wrap=wrap)
    assert not result["correct"]


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in cells.BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & harness.FORBIDDEN, path


def test_a_run_loads_no_jax_module():
    # Whole top-level names: the port's name begins with the JAX package's.
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from hopper_bench.core import cells, harness\n"
        "import hopper_bench.controls\n"
        "for w in ['bs32k_sorted.device_decompress', 'bs32k_sorted.device_compress']:\n"
        "    c = cells.load_cell(w); cells.load_driver(c)\n"
        "    [cells.load_reader(c, m['name']) for m in c.per_layer]\n"
        "from pim_compression_tpu_torch import TorchCodecConfig\n"
        "from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, _build\n"
        "from pim_compression_tpu_torch.runtime import pipeline\n"
        "assert 'pim_compression_tpu_torch' in sys.modules\n"
        "print(','.join(harness.forbidden_modules()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(cells.CHECKOUT)], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pim_compression_tpu_torch_fake", None)
    assert "pim_compression_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pim_compression_tpu.fake", None)
    assert "pim_compression_tpu" in harness.forbidden_modules()
