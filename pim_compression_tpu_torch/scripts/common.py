"""What the probe scripts share: the device check, CUDA-event timing, the record file."""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import time

import torch

OUT_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "probes"

# Datasheet rates of an H100 SXM at its 700 W limit (dense, no sparsity).
DATASHEET = "H100 SXM datasheet"
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Clock cycles the card spends spinning before a timed run: about 100 us of
# host enqueue per call at 2 GHz, so every timed launch is queued before the
# first starts and the events time the device, not the launching host.
BACKLOG_CYCLES_PER_CALL = 200_000
L2_BYTES = 50 * 2**20


def cold_copies(x: torch.Tensor, limit: int = 8) -> list[torch.Tensor]:
    """x and clones of it, enough (twice the 50 MB L2 in all, at most
    ``limit``) that a timed loop taking them in turn reads each one from
    device memory and not from L2, as a first use would."""
    n = min(limit, max(1, -(-2 * L2_BYTES // max(1, x.numel() * x.element_size()))))
    return [x] + [x.clone() for _ in range(n - 1)]


def cuda_device(device) -> torch.device:
    """The CUDA device to measure; raises for any other device or without one."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the probes measure a CUDA device, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("the probes need a CUDA device; none is available")
    return torch.device("cuda", dev.index if dev.index is not None else torch.cuda.current_device())


def card(dev: torch.device) -> dict:
    """The card's name and, where nvidia-smi answers, its power limit."""
    limit = None
    if shutil.which("nvidia-smi"):
        proc = subprocess.run(
            ["nvidia-smi", f"--id={dev.index}", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        )
        limit = proc.stdout.strip() or None
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit}


def event_seconds(fn, reps: int, warmup: int = 1) -> float:
    """Mean seconds per call of fn on the card: CUDA events around reps
    calls, after warmup calls. A spin kernel ahead of the first event holds
    the stream while the host queues all reps calls, so the time is the
    device's for back-to-back launches, without the host's launch cost."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(BACKLOG_CYCLES_PER_CALL * (reps + 1))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps / 1e3


def warm(dev: torch.device) -> None:
    """Keep the card busy for about 0.1 s, so that a measurement starts at
    the clock the card runs at under load and not at its idle clock."""
    with torch.cuda.device(dev):
        torch.cuda._sleep(200_000_000)
        torch.cuda.synchronize()


def host_seconds(fn, reps: int = 5) -> float:
    """Fastest wall time of reps calls of fn (which must end synchronised),
    after one call to warm up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(name: str, run, description: str, argv: list[str] | None = None) -> int:
    """Parse ``--device``, run, and write the records to ``OUT_DIR/<name>.json``."""
    parser = argparse.ArgumentParser(prog=f"python -m pim_compression_tpu_torch.scripts.{name}",
                                     description=description)
    parser.add_argument("--device", default="cuda:0", help="the CUDA device to measure (default cuda:0)")
    records = run(parser.parse_args(argv).device)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{name}.json"
    path.write_text(json.dumps(records, indent=2) + "\n")
    print(f"wrote {path}")
    return 0
