"""Cells by name: the manifest, and the files each name points to.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. Each
has a file of its own under the benchmark's folder, found by its name:

- ``configs/<config>.json``: the codec's knobs and the source they follow;
- ``traffic/<traffic>.json``: the mix's parameters, and the driver module
  (``drivers/<driver>.py``) that reads them;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number, or None where the run has nothing to read.

So a configuration, a mix or a metric comes in as new files and manifest
entries, and no file here changes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent
MANIFEST = CHECKOUT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the manifest's end-to-end metrics this cell reports
    per_layer: list  # the manifest's per-layer metrics this cell reports
    bench_dir: pathlib.Path


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, manifest: pathlib.Path = MANIFEST, bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell named ``workload``, with its configuration and traffic
    files read and the metrics it reports picked from the manifest: an
    end-to-end metric where its ``workloads`` lists the cell or it has none;
    a per-layer metric where its ``workloads`` lists the cell, or, without
    the key, where the cell reports the end-to-end metric it moves."""
    spec = load_json(manifest)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest}; have {sorted(cells)}")
    w = cells[workload]
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in spec["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir,
    )


def load_module(path: pathlib.Path, kind: str):
    """A module of the benchmark's folder, loaded from its file: its name
    may hold dots (``enqueue_ms.decompress.py``)."""
    tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:10]
    name = f"hopper_bench_{kind}_{path.stem.replace('.', '_').replace('-', '_')}_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_driver(cell: Cell):
    return load_module(cell.bench_dir / "drivers" / f"{cell.traffic['driver']}.py", "driver")


def load_reader(cell: Cell, metric: str):
    return load_module(cell.bench_dir / "metrics" / f"{metric}.py", "metric").read
