"""The reduction of a profiler trace to the numbers the per-layer metrics read.

Reads the events of ``torch.profiler``'s ``export_chrome_trace`` JSON
(complete events, ``"ph": "X"``, times in microseconds on one clock for the
host and the card): the device's operations (kernels, copies, fills), and
the benchmark's own host spans (``record_function``), among them the
``window`` span around the measured window. The window holds nothing on
the device but what the entry under test launches, so every device
operation in it is the entry's.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"user_annotation"})
WINDOW = "window"
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float  # the traced window's length
    busy_s: float  # seconds in it with an operation on the card
    device_s: float  # the operations' own seconds in the window, summed
    device_ops: list  # [[name, seconds], ...], the most time first
    idle_gaps: list  # [[host span, seconds], ...], the most time first

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s if self.window_s > 0 else 0.0


def load_events(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: list) -> list:
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events: list) -> Summary | None:
    """The traced window's numbers, or None where the trace has no window
    span or no device operation in it."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in complete if e.get("cat") in HOST_CATS and e.get("name") == WINDOW]
    if not windows:
        return None
    win = max(windows, key=lambda e: e["dur"])
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ops = []
    for e in complete:
        if e.get("cat") in DEVICE_CATS:
            s, t = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
            if t > s:
                ops.append((s, t, e.get("name", "?")))
    if not ops:
        return None
    busy = _union([[s, t] for s, t, _ in ops])
    by_name: collections.Counter = collections.Counter()
    for s, t, name in ops:
        by_name[name] += (t - s) * 1e-6
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in complete if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
    )
    gaps: collections.Counter = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for start, end in zip(edges[::2], edges[1::2]):
        if end > start:
            gaps[_host_span(spans, (start + end) / 2)] += (end - start) * 1e-6
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(t - s for s, t in busy) * 1e-6,
        device_s=sum(by_name.values()),
        device_ops=[[n, v] for n, v in by_name.most_common(TOP)],
        idle_gaps=[[n, v] for n, v in gaps.most_common(TOP)],
    )


def _host_span(spans: list, at: float, depth: int = 4) -> str:
    """The innermost benchmark span that covers time ``at``, or "other";
    ``spans`` sorted by start, nested at most ``depth`` deep."""
    best = None
    i = bisect.bisect_right(spans, (at, float("inf"), "")) - 1
    for s, t, name in spans[max(0, i - depth + 1) : i + 1]:
        if s <= at <= t and (best is None or t - s < best[1] - best[0]):
            best = (s, t, name)
    return best[2] if best else "other"
