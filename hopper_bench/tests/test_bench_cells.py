"""The manifest and the files it names: every cell loads, the manifest keeps
to the benchmark's contract, and a configuration, a mix and a per-layer
metric come in as new files alone."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from hopper_bench.core import cells
from hopper_bench.tests.bench_tiny import make_bench, tiny_cell

SPEC = cells.load_json(cells.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_with_its_metrics(workload):
    cell = cells.load_cell(workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.chips == 1
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(cells.load_reader(cell, m["name"]))
    assert cells.load_driver(cell).Driver


def test_manifest_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["hopper_bench"] and SPEC["command"][1].startswith("hopper_bench/")
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (cells.CHECKOUT / c["file"]).is_file() and c["file"].startswith("hopper_bench/")
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in SPEC["end_to_end"]}["setup_s"] == 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for item in SPEC["configs"] + SPEC["workloads"]:
        assert NAME.match(item["name"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_a_config_a_mix_and_a_metric_come_in_as_new_files(tmp_path):
    bench = make_bench(tmp_path)
    before = _digests(bench)
    (bench / "configs" / "wide.json").write_text(json.dumps(
        {"name": "wide", "codec": {"block_size": 2048, "batch_blocks": 2, "engine": "cuda"}}))
    (bench / "traffic" / "deep_compress.json").write_text(json.dumps(
        {"driver": "device_batches", "entry": "compress", "in_flight": 2, "resident_mib": 16 / 1024,
         "base_mib": 8 / 1024, "text_seed": 7}))
    (bench / "metrics" / "calls_per_s.compress.py").write_text(
        "def read(run):\n    return run.calls / run.window_s if run.entry == 'compress' and run.window_s else None\n")
    # The manifest is the one file that grows: new entries in its lists.
    spec = json.loads((bench / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "wide", "source": "test", "file": "x", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "wide.deep_compress", "config": "wide", "traffic": "deep_compress",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("compress_gbps", "compress_ratio"):
            m["workloads"].append("wide.deep_compress")
    spec["per_layer"].append({"name": "calls_per_s.compress", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "ops entry", "moves": "compress_gbps"})
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(bench)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {bench / "BENCHMARK.json"}

    cell = cells.load_cell("wide.deep_compress", bench / "BENCHMARK.json", bench)
    assert cell.config["codec"]["block_size"] == 2048 and cell.traffic["in_flight"] == 2
    assert "calls_per_s.compress" in [m["name"] for m in cell.per_layer]  # no workloads key: moves compress_gbps
    assert "calls_per_s.compress" not in [m["name"] for m in tiny_cell(bench, "decompress").per_layer]
    reader = cells.load_reader(cell, "calls_per_s.compress")
    driver = cells.load_driver(cell)
    record = driver.Record(entry="compress", calls=10, window_s=2.0, enqueue_s=[], function_bytes=0)
    assert reader(record) == 5.0
    assert reader(driver.Record(entry="decompress", calls=10, window_s=2.0, enqueue_s=[], function_bytes=0)) is None
