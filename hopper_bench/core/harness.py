"""One run of one cell: set-up, the window, the trace, the comparison, the
result line.

``run_cell`` does everything but look for the card, so the tests drive it
on the CPU at a small size, with a fault planted under the timed path.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import tempfile
import time

import torch

from hopper_bench.core import cells, trace

# Top-level module names a run may not hold once its window has closed,
# compared whole: the port's own name begins with the JAX package's.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pim_compression_tpu"})


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


class Phases:
    """Seconds of each named step of set-up, in order."""

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - start


def traced_span(name: str):
    return torch.profiler.record_function(name)


def null_span(name: str):
    return contextlib.nullcontext()


def _device_info(device: torch.device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


def _summarize(prof) -> trace.Summary | None:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.summarize(trace.load_events(path))
    finally:
        pathlib.Path(path).unlink(missing_ok=True)


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device: torch.device,
             started: float, entry_wrap=None, calls: int | None = None, log=None,
             start: dict | None = None) -> tuple[dict, int]:
    """Run ``cell`` once; returns (the result's object, exit code). The set-up
    clock started at ``started`` (``time.perf_counter()``, at the process's
    start). ``entry_wrap(kind, entry)``, where given, returns what the
    window calls in the entry's place; ``calls``, where given, ends the
    window after that many calls instead of ``seconds``; ``start`` holds
    the seconds of set-up spent before this call, by name, for the split."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    driver = cells.load_driver(cell).Driver(cell, seed, device, seconds)
    phases = Phases()
    phases.seconds.update(start or {})
    driver.setup(phases)
    setup_s = time.perf_counter() - started
    print(json.dumps({"setup_s": setup_s, "setup_split_s": phases.seconds}), flush=True)
    entry = entry_wrap(driver.kind, driver.entry) if entry_wrap else None

    if traced:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            record = driver.window(seconds, traced_span, entry=entry, max_calls=calls)
    else:
        record = driver.window(seconds, null_span, entry=entry, max_calls=calls)
    dev = _device_info(device, cell.chips)
    end_to_end = driver.end_to_end(record)

    after = Phases()
    with after("collect"):
        driver.collect()
        driver.release()
    if traced:
        with after("trace"):
            record.trace = _summarize(prof)
            del prof
    with after("check"):
        checks = driver.check()
    log(json.dumps({"after_window_s": after.seconds}))

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = cells.load_reader(cell, m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if record.trace is not None:
            dev["busy_s"] = record.trace.busy_s
            dev["window_s"] = record.trace.window_s
    else:
        values = dict(end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}

    correct = all(v <= limit for v, limit in checks.values())
    result = {
        "correct": correct, "attempted": record.calls, "failed": driver.failed,
        "metrics": metrics, "device": dev,
    }
    if traced and record.trace is not None:
        result["breakdown"] = {"device_ops": record.trace.device_ops, "idle_gaps": record.trace.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    found = forbidden_modules()
    if found:
        log(f"the run holds modules it may not: {', '.join(found)}")
        return {}, 3
    for k, (v, limit) in checks.items():
        log(f"check {k} {v} limit {limit}")
    return result, 0
