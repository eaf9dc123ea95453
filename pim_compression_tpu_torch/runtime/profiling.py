"""Phase-taxonomy profiling, copied from ``pim_compression_tpu.runtime.profiling``.

The original cannot be imported without JAX (its package imports the JAX
runtime). Phases: ``pre`` (host scan/blockize) / ``h2d`` / ``kernel`` /
``d2h`` / ``post``, plus ``compile`` for one-time kernel build and device
set-up (the CUDA context, the staging ring's streams and its first pinned
allocation). Each phase is host wall time. In synchronous mode
(``pipeline_depth <= 1`` or a single batch) a device phase is closed by a
synchronising call, so its time includes the device work; with batches in
flight ``h2d`` and ``kernel`` are the host's time to stage and enqueue, and
``d2h`` holds the wait for each batch (``runtime.api``).
"""

from __future__ import annotations

import contextlib
import json
import time


PHASES = ("pre", "compile", "h2d", "kernel", "d2h", "post")


class PhaseTimer:
    def __init__(self) -> None:
        self.seconds: dict[str, float] = {p: 0.0 for p in PHASES}
        # Free-form run metadata surfaced in both the human and JSON outputs.
        self.notes: dict[str, str] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in self.seconds:
            self.seconds[name] = 0.0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0

    @property
    def total(self) -> float:
        return sum(self.seconds.values())

    def human(self) -> str:
        lines = [f"{name} time: {secs:.6f}s" for name, secs in self.seconds.items()]
        lines.append(f"Total time: {self.total:.6f}s")
        lines.extend(f"note {k}: {v}" for k, v in self.notes.items())
        return "\n".join(lines)

    def json(self, **extra) -> str:
        payload = {"phases_s": self.seconds, "total_s": self.total, **extra}
        if self.notes:
            payload["notes"] = self.notes
        return json.dumps(payload)
