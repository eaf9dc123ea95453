"""The benchmark's exact comparison of the sweep cell, on the CPU.

``hopper_bench/drivers/device_batches_exact.py`` adds
``stream_mismatch_blocks`` to ``device_batches``' ``bad_blocks``: kept
blocks held to the plain reference (``yardstick/sweep_ref.py``) stream for
stream. Whole runs of a tiny sweep cell (1 KB blocks, 4 a batch) through
the harness, with the port's entry on CPU tensors: a sound run reads 0 on
both; a sweep with half the window planted under the timed path
(``core/sweep_faults.py``) stays lossless, so ``bad_blocks`` reads 0, and
the exact comparison finds it. And the ``bs8k_sweep.device_compress`` cell
loads with its metrics.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from hopper_bench.core import cells, sweep_faults
from hopper_bench.tests.bench_tiny import make_bench

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

TINY_SWEEP = {"block_size": 1024, "batch_blocks": 4, "engine": "cuda", "matcher": "sweep", "match_window": 256,
              "coarse_window": 1024, "coarse_mode": "granular"}
CELL = "tiny.device_compress_exact"


# Each run goes through the harness in an interpreter of its own: a run
# refuses to print a result while JAX or the JAX package is loaded, as other
# test files of the same worker may have loaded them.
RUNS = """
import json, pathlib, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
from hopper_bench.core import cells, faults, harness, sweep_faults
bench = pathlib.Path(sys.argv[2])
out = {}
for name, seed, wrap in (("sound", 2**31 + 29, None), ("narrow", 41, sweep_faults.narrow),
                         ("stale", 43, faults.stale), ("altered", 43, faults.altered)):
    cell = cells.load_cell(sys.argv[3], bench / "BENCHMARK.json", bench)
    result, code = harness.run_cell(cell, seed, 60.0, False, torch.device("cpu"), time.perf_counter(),
                                    entry_wrap=wrap, calls=4, log=lambda msg: None)
    out[name] = dict(result, code=code)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """A sound run and runs with each fault planted, of the tiny benchmark
    folder with a sweep configuration and the exact mix."""
    bench = make_bench(tmp_path_factory.mktemp("bench"), TINY_SWEEP)
    traffic = cells.load_json(cells.BENCH_DIR / "traffic" / "device_compress_exact.json")
    traffic.update(resident_mib=16 / 1024, base_mib=8 / 1024)
    (bench / "traffic" / "device_compress_exact.json").write_text(json.dumps(traffic))
    spec = cells.load_json(bench / "BENCHMARK.json")
    spec["workloads"].append({"name": CELL, "config": "tiny", "traffic": "device_compress_exact", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("compress_gbps", "compress_ratio"):
            m["workloads"].append(CELL)
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", RUNS, str(cells.CHECKOUT), str(bench), CELL], capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_sound_sweep_run_is_exact(runs):
    result = runs["sound"]
    assert result["code"] == 0 and result["correct"] and result["failed"] == 0 and result["attempted"] == 4
    assert result["checks"] == {"bad_blocks": {"value": 0, "limit": 0},
                                "stream_mismatch_blocks": {"value": 0, "limit": 0}}
    assert set(result["metrics"]) == {"compress_gbps", "compress_ratio", "setup_s"}


def test_a_narrower_sweep_is_lossless_but_not_exact(runs):
    result = runs["narrow"]
    checks = result["checks"]
    assert checks["bad_blocks"]["value"] == 0  # every stream still decodes to its plaintext
    assert checks["stream_mismatch_blocks"]["value"] > 0
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("fault", ["stale", "altered"])
def test_a_broken_answer_fails_both_comparisons(runs, fault):
    checks = runs[fault]["checks"]
    assert checks["bad_blocks"]["value"] > 0 and checks["stream_mismatch_blocks"]["value"] > 0
    assert not runs[fault]["correct"]


def test_narrow_takes_only_the_sweep_compress_entry():
    from pim_compression_tpu_torch.ops import hopper_encode

    entry = hopper_encode.encode_blocks
    with pytest.raises(ValueError):
        sweep_faults.narrow("decompress", entry)
    with pytest.raises(ValueError):
        sweep_faults.narrow("compress", entry)  # no knobs: not the sweep's entry


def test_the_sweep_cell_loads_with_its_metrics():
    cell = cells.load_cell("bs8k_sweep.device_compress")
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"compress_gbps", "compress_ratio", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "enqueue_ms.compress", "encode_roofline", "device_idle.compress", "emit_walk_balance", "sweep_walk_ms",
        "sweep_entries_per_pos"}  # no match kernel runs: no match_sort_ms
    for m in cell.per_layer:
        assert callable(cells.load_reader(cell, m["name"]))
    assert cell.config["codec"] == {"block_size": 8192, "batch_blocks": 1024, "engine": "cuda", "matcher": "sweep",
                                    "match_window": 2048, "coarse_window": 8192, "coarse_mode": "granular"}
    # device_compress's parameters unchanged, and the exact comparison's draw.
    plain = cells.load_json(cells.BENCH_DIR / "traffic" / "device_compress.json")
    assert {k: cell.traffic[k] for k in plain if k not in ("driver", "why")} == {
        k: v for k, v in plain.items() if k not in ("driver", "why")}
    assert cell.traffic["driver"] == "device_batches_exact" and cell.traffic["exact_blocks"] >= 64
    driver = cells.load_driver(cell)
    assert driver.LIMITS == {"compress": {"bad_blocks": 0, "stream_mismatch_blocks": 0}}
    base = cells.load_module(cells.BENCH_DIR / "drivers" / "device_batches.py", "driver")
    assert issubclass(driver.Driver, base.Driver) and driver.Record is base.Record
    assert driver.Driver.window is base.Driver.window  # the window is device_batches' own
