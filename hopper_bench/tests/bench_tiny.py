"""A benchmark folder at a size the CPU runs in seconds, for the tests.

It copies the real drivers and metric readers and adds one tiny
configuration (1 KB blocks, 4 a batch) under both mixes, with a working
set of 16 KiB made of 2 copies of an 8 KiB base: 4 batches.
"""

from __future__ import annotations

import json
import pathlib
import shutil

from hopper_bench.core import cells

TINY_CODEC = {"block_size": 1024, "batch_blocks": 4, "engine": "cuda"}
COMPRESS_METRICS = {"compress_gbps", "compress_ratio", "enqueue_ms.compress", "encode_roofline", "device_idle.compress"}


def make_bench(root: pathlib.Path, codec: dict = TINY_CODEC) -> pathlib.Path:
    """A folder under ``root`` with configs/, traffic/, drivers/, metrics/
    and a manifest, ``BENCHMARK.json``, beside them; returns the folder."""
    bench = root / "bench"
    for sub in ("drivers", "metrics"):
        shutil.copytree(cells.BENCH_DIR / sub, bench / sub, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    (bench / "configs" / "tiny.json").write_text(json.dumps({"name": "tiny", "codec": codec}))
    for entry in ("decompress", "compress"):
        traffic = {"driver": "device_batches", "entry": entry, "in_flight": 4,
                   "resident_mib": 16 / 1024, "base_mib": 8 / 1024, "text_seed": 20261016}
        (bench / "traffic" / f"device_{entry}.json").write_text(json.dumps(traffic))
    spec = cells.load_json(cells.MANIFEST)
    spec["workloads"] = [
        {"name": f"tiny.device_{e}", "config": "tiny", "traffic": f"device_{e}", "chips": 1, "why": "test"}
        for e in ("decompress", "compress")
    ]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.device_" + ("compress" if m["name"] in COMPRESS_METRICS else "decompress")]
    (bench / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def tiny_cell(bench: pathlib.Path, entry: str) -> cells.Cell:
    return cells.load_cell(f"tiny.device_{entry}", bench / "BENCHMARK.json", bench)
