"""Profiling of the port: a run's phases, and the codec kernels' own spans and counters.

Phases, copied from ``pim_compression_tpu.runtime.profiling`` (the original
cannot be imported without JAX: its package imports the JAX runtime):
``pre`` (host scan/blockize) / ``h2d`` / ``kernel`` / ``d2h`` / ``post``,
plus ``compile`` for one-time kernel build and device set-up (the CUDA
context, the staging ring's streams and its first pinned allocation). Each
phase is host wall time. In synchronous mode (``pipeline_depth <= 1`` or a
single batch) a device phase is closed by a synchronising call, so its time
includes the device work; with batches in flight ``h2d`` and ``kernel`` are
the host's time to stage and enqueue, and ``d2h`` holds the wait for each
batch (``runtime.api``).

Kernel spans. While a ``torch.profiler`` session records, unless
``KERNEL_SPANS`` is False, the entries of the four codec kernels
(``ops.hopper_decode.decode_blocks``, ``ops.hopper_match.match_blocks``,
``ops.hopper_sweep.sweep_match``, ``ops.hopper_encode.emit_blocks``)
launch each kernel's traced
instantiation with a record of its own (``csrc/trace.cuh``) and open a
``record_function`` span around their checks, their allocations and the
launch (``<entry>.check``, ``.alloc``, ``.launch``). Outside a session they
read one attribute and launch the plain kernel. A record holds one launch's
earliest start and latest end (``%globaltimer``), the sum and number of its
walks (decode, emit: a warp's block) or CTAs (match, sweep), and the
kernel's counters, ``COUNTERS``. The first traced launch of a session on a device
allocates the session's records there (``CAPACITY``, zeroed) and calibrates
the device's ``%globaltimer`` against the host clock (``CLOCK_REALTIME``,
the clock ``torch.profiler`` puts its host events on); later launches take
the next record, and once all are taken a launch runs plain and counts as
dropped. ``kernel_summary()`` reads the latest session's records back and
calibrates again; ``reduce_records`` is its arithmetic on NumPy arrays
alone. ``add_kernel_spans`` writes the launches into an exported trace (the
CLI's ``--profile``), placed on the trace's device timeline by the
calibrating probe kernels' own events (``timeline_points``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
import warnings

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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


# -- kernel spans --------------------------------------------------------

KERNEL_SPANS = None  # False: a profiler session runs the plain kernels, with no span or record
CAPACITY = 65536  # records of a session on a device; about 22,000 decode launches fill a 10 s window at 32 KB
RECORD_WORDS = 16  # 64-bit words of a record (pim::TraceRecord)
CALIBRATION_TRIES = 8
KERNEL_NAMES = {"decode": "decode_blocks_kernel", "match": "match_blocks_kernel", "sweep": "sweep_blocks_kernel",
                "emit": "emit_blocks_kernel"}
KERNELS = tuple(KERNEL_NAMES)
MATCH_PHASES = ("stage", "sort", "lags", "select", "fold")
SWEEP_PHASES = ("stage", "sort", "ranks", "lanes", "rounds")
PHASES_OF = {"match": MATCH_PHASES, "sweep": SWEEP_PHASES}  # kernels that record CTA-cycles by phase
# Each of the four kernels' counters, the record's words 4, 5, ... in order:
# the decode's elements walked, those on the general path, bytes copied by
# valid copy elements and those of them read from the row past the ring; the
# match kernel's CTA-cycles in each phase and in all, then, in the second
# half of a rung that sorts its 32 KB halves in turn, the warps' cycles in the
# key-indexed lookup, the lookups and those that found a first-half word
# (csrc/match.cu); the
# sweep kernel's CTA-cycles in each phase and in all, then the positions it
# walked, the entries its lanes visited, the positions handed to a warp, the
# entries the warps' rounds visited (32 a round) and the entries past the
# window, of both (csrc/sweep.cu); none of the emit's.
COUNTERS = {
    "decode": ("elements", "general", "copied", "from_row"),
    "match": (*MATCH_PHASES, "total", "lookup", "lookups", "hits"),
    "sweep": (*SWEEP_PHASES, "total", "positions", "lane_entries", "handed", "round_entries", "coarse_entries"),
    "emit": (),
}


@dataclasses.dataclass
class ClockPoint:
    """One calibration: the host time of a ``%globaltimer`` reading, and the
    calibrating probe kernel's own first and last ``%globaltimer`` reading
    (0 where not known)."""

    device_ns: int
    host_ns: int
    uncertainty_ns: int  # half the distance between the two host readings around it
    probe_begin_ns: int = 0
    probe_end_ns: int = 0


@dataclasses.dataclass
class KernelSummary:
    """One kernel's traced launches in a session, summed."""

    kernel: str
    launches: int  # launches recorded
    dropped: int  # launches left unrecorded by a full buffer (they ran plain)
    walks: int  # the launches' walks (decode, emit: one a warp's block) or CTAs (match, sweep)
    span_ns: int  # their durations, summed
    window_ns: int  # over launches, walks x (latest end - earliest start), summed
    counters: dict  # COUNTERS[kernel] -> sum over launches
    records: np.ndarray  # int64 [launches, RECORD_WORDS], as the kernel wrote them
    spans: np.ndarray | None  # int64 [launches, 2]: earliest start, latest end on the host clock, ns
    uncertainty_ns: int | None  # of those spans, from the calibrations
    probes: tuple = ()  # the session's clock probe kernels, (first, last reading) on the host clock, ns

    @property
    def walk_balance(self) -> float | None:
        """How close the mean walk (CTA) comes to the launch's whole span."""
        return self.span_ns / self.window_ns if self.window_ns > 0 else None

    def share(self, part: str, whole: str) -> float | None:
        """counters[part] / counters[whole], or None where whole is 0."""
        return self.counters[part] / self.counters[whole] if self.counters[whole] else None


def tightest(readings, probe=(0, 0)) -> ClockPoint:
    """The calibration of the try whose host readings lie closest together;
    ``readings`` is int64 [tries, 3]: host ns before, ``%globaltimer`` ns,
    host ns after; ``probe`` the probe kernel's first and last reading."""
    r = np.asarray(readings, dtype=np.int64).reshape(-1, 3)
    i = int(np.argmin(r[:, 2] - r[:, 0]))
    before, device, after = (int(x) for x in r[i])
    return ClockPoint(device_ns=device, host_ns=before + (after - before) // 2,
                      uncertainty_ns=(after - before + 1) // 2, probe_begin_ns=int(probe[0]),
                      probe_end_ns=int(probe[1]))


def to_host_ns(device_ns, first: ClockPoint, last: ClockPoint | None = None) -> np.ndarray:
    """Host-clock ns of ``%globaltimer`` readings: shifted by ``first``'s
    offset, and with ``last`` by the offset interpolated between the two
    (the two clocks drift apart)."""
    g = np.asarray(device_ns, dtype=np.int64)
    offset = first.device_ns - first.host_ns
    if last is None or last.device_ns == first.device_ns:
        return g - offset
    drift = (last.device_ns - last.host_ns) - offset
    slope = drift / (last.device_ns - first.device_ns)
    return g - offset - np.rint((g - first.device_ns) * slope).astype(np.int64)


def timeline_points(events, probes, base_ns: int = 0) -> list:
    """Where a profiler's device timeline puts the session's clock probes:
    for each probe in ``probes`` (its first and last reading on the host
    clock, ns) that ``events``, an exported trace whose times count from
    ``base_ns``, holds as a kernel event within 1 ms, (the probe's start on
    the host clock, the shift that moves it onto its event, half the
    disagreement between its start's and its end's shift). Each event serves
    one probe; a probe whose own event is missing gets none (a profiler can
    drop the last records of a session). The profiler maps device times onto
    its host clock itself (CUPTI), and on an H100 that mapping was seen to
    run off ours by up to 0.3 us a millisecond within a session and by tens
    of microseconds from one session to the next."""
    found = [(base_ns + round(float(e["ts"]) * 1000), round(float(e["dur"]) * 1000)) for e in events
             if e.get("cat") == "kernel" and "clock_probe_kernel" in e.get("name", "") and "dur" in e]
    points = []
    for begin, end in probes or ():
        near = [(abs(start - begin), start, dur) for start, dur in found if abs(start - begin) <= 1_000_000]
        if near:
            _, start, dur = min(near)
            found.remove((start, dur))
            d0, d1 = start - begin, start + dur - end
            points.append((begin, (d0 + d1) // 2, abs(d0 - d1) // 2))
    return points


def on_timeline(spans, points) -> np.ndarray:
    """``spans`` (host ns) moved onto a trace's device timeline: by the one
    point's shift, or by the shift interpolated in host time between the
    first and the last point (``timeline_points``)."""
    spans = np.asarray(spans, dtype=np.int64)
    if not points:
        return spans
    (t0, s0, _), (t1, s1, _) = points[0], points[-1]
    if t1 == t0:
        return spans + s0
    return spans + s0 + np.rint((spans - t0) * ((s1 - s0) / (t1 - t0))).astype(np.int64)


def launch_spans(records) -> np.ndarray:
    """int64 [n, 2]: each record's earliest start and latest end
    (``%globaltimer`` ns), 0 for a record no walk or CTA wrote."""
    u = np.asarray(records, dtype=np.int64).reshape(-1, RECORD_WORDS).view(np.uint64)
    live = u[:, 3] > 0
    start = np.where(live, ~u[:, 0], 0).astype(np.int64)
    end = np.where(live, u[:, 1], 0).astype(np.int64)
    return np.stack([start, end], axis=1)


def reduce_records(records, kinds, dropped: dict | None = None, spans=None,
                   uncertainty_ns: int | None = None, probes: tuple = ()) -> dict:
    """Each kernel's ``KernelSummary`` from its launches' records.

    ``records`` int64 [n, RECORD_WORDS] as the kernels wrote them,
    ``kinds`` the kernel of each (``KERNELS``), ``dropped`` kernel ->
    launches a full buffer left out, ``spans`` int64 [n, 2] of each launch
    on the host clock (or None) and their uncertainty, ``probes`` the clock
    probes' spans there. A kernel appears if it has a record or a dropped
    launch.
    """
    records = np.asarray(records, dtype=np.int64).reshape(-1, RECORD_WORDS)
    kinds = np.asarray(list(kinds), dtype=object)
    dropped = dropped or {}
    own = launch_spans(records)
    out = {}
    for kernel in KERNELS:
        rows = np.flatnonzero(kinds == kernel)
        if not len(rows) and not dropped.get(kernel):
            continue
        r = records[rows]
        count = r[:, 3]
        width = own[rows, 1] - own[rows, 0]
        out[kernel] = KernelSummary(
            kernel=kernel, launches=len(rows), dropped=int(dropped.get(kernel, 0)),
            walks=int(count.sum()), span_ns=int(r[:, 2].sum()), window_ns=int((count * width).sum()),
            counters={name: int(r[:, 4 + i].sum()) for i, name in enumerate(COUNTERS[kernel])},
            records=r, spans=None if spans is None else np.asarray(spans, dtype=np.int64)[rows],
            uncertainty_ns=None if spans is None else uncertainty_ns, probes=tuple(probes),
        )
    return out


def launch_args(kernel: str, record) -> dict:
    """What one launch's record says, for a trace event: its walks (CTAs),
    walk balance, counters and, for the match and sweep kernels, each
    phase's share of the CTA-cycles, in %."""
    k = reduce_records(np.asarray(record)[None], [kernel])[kernel]
    args = {"ctas" if kernel in PHASES_OF else "walks": k.walks}
    if k.walk_balance is not None:
        args["walk_balance_%"] = round(100 * k.walk_balance, 3)
    args.update(k.counters)
    if kernel in PHASES_OF and k.counters["total"]:
        args.update({f"{p}_%": round(100 * k.share(p, "total"), 3) for p in PHASES_OF[kernel]})
    return args


def _sessions_started() -> int:
    """Profiler sessions started since the first traced launch (0 where torch
    has no start hook to count them: then every traced launch is of one
    session)."""
    return getattr(getattr(_autograd_profiler, "_run_on_profiler_start", None), "sessions", 0)


def _count_sessions() -> None:
    """Wrap torch's hook at a profiler's start, once in a process, to count
    the sessions that start from now on."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if start is None or hasattr(start, "sessions"):
        return

    def run_on_profiler_start(*args, **kwargs):
        run_on_profiler_start.sessions += 1
        return start(*args, **kwargs)

    run_on_profiler_start.sessions = 0
    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


@dataclasses.dataclass
class _DeviceRecords:
    device: torch.device
    buffer: torch.Tensor  # int64 [CAPACITY, RECORD_WORDS], zeroed
    kinds: list  # the kernel of each record taken, in order
    dropped: dict  # kernel -> launches that found every record taken
    clock: ClockPoint | None  # the calibration at the first traced launch (CUDA)


@dataclasses.dataclass
class _Session:
    number: int  # _sessions_started() when it began
    devices: dict = dataclasses.field(default_factory=dict)  # device -> _DeviceRecords
    summary: dict | None = None
    summarized: int = -1  # launches the summary saw

    @property
    def launches(self) -> int:
        return sum(len(d.kinds) + sum(d.dropped.values()) for d in self.devices.values())


_lock = threading.Lock()
_session: _Session | None = None


def calibrate(device, tries: int = CALIBRATION_TRIES, attempts: int = 3) -> ClockPoint | None:
    """Calibrate a CUDA device's ``%globaltimer`` against the host clock
    (``csrc/trace.cu``): the tightest of ``tries``; a call in which no try
    finished is made again, up to ``attempts`` calls, and after those None,
    with a warning."""
    from pim_compression_tpu_torch.ops import _build

    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    codes = []
    for _ in range(attempts):
        out = np.zeros(3 * tries + 2, dtype=np.int64)
        done = _build.load().pim_clock_calibrate(index, tries, out.ctypes.data)
        if done > 0:
            return tightest(out[: 3 * done], out[3 * tries :])
        codes.append(done)
    warnings.warn(f"kernel spans: %globaltimer calibration failed on cuda:{index} ({codes}); spans stay unmapped")
    return None


def _open(device: torch.device) -> _DeviceRecords:
    buffer = torch.zeros((CAPACITY, RECORD_WORDS), dtype=torch.int64, device=device)
    clock = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the zeros are in place before a kernel on any stream writes a record
        clock = calibrate(device)
    return _DeviceRecords(device, buffer, [], {}, clock)


def launch_record(kernel: str, device) -> int | None:
    """The device address of a fresh record for one traced launch of
    ``kernel`` (``KERNELS``) on ``device``, or None where the session's
    records there are all taken: the launch then runs the plain kernel and
    counts as dropped. The first call of a profiler session on a device
    allocates its records and calibrates its clock."""
    global _session
    device = torch.device(device)
    with _lock:
        _count_sessions()
        number = _sessions_started()
        if _session is None or _session.number != number:
            old, _session = _session, _Session(number)
            for recs in (old.devices.values() if old else ()):
                if recs.device.type == "cuda":
                    torch.cuda.synchronize(recs.device)  # no kernel writes the old records once they are freed
        recs = _session.devices.get(device)
        if recs is None:
            recs = _session.devices[device] = _open(device)
        slot = len(recs.kinds)
        if slot >= recs.buffer.shape[0]:
            recs.dropped[kernel] = recs.dropped.get(kernel, 0) + 1
            return None
        recs.kinds.append(kernel)
        return recs.buffer.data_ptr() + slot * RECORD_WORDS * recs.buffer.element_size()


def kernel_summary() -> dict | None:
    """Each kernel's ``KernelSummary`` (keys ``"decode"``, ``"match"``,
    ``"sweep"``, ``"emit"``, those launched) of the latest profiler session, or None
    where that session launched no traced kernel. Synchronises each device
    the session traced on, copies its records to the host and calibrates
    its clock again, so each launch's span is mapped onto the host clock
    between the session's two calibrations; the result is kept until the
    session traces another launch."""
    with _lock:
        s = _session
        if s is None or s.number != _sessions_started() or not s.launches:
            return None
        if s.summary is not None and s.summarized == s.launches:
            return s.summary
        records, kinds, spans, dropped, uncertainty, probes = [], [], [], {}, 0, ()
        for recs in s.devices.values():
            n = len(recs.kinds)
            if recs.device.type == "cuda":
                torch.cuda.synchronize(recs.device)
            rows = recs.buffer[:n].cpu().numpy()
            records.append(rows)
            kinds += recs.kinds
            for k, v in recs.dropped.items():
                dropped[k] = dropped.get(k, 0) + v
            if spans is not None and recs.clock is not None:
                last = calibrate(recs.device)
                spans.append(to_host_ns(launch_spans(rows), recs.clock, last))
                uncertainty = max(uncertainty, recs.clock.uncertainty_ns, last.uncertainty_ns if last else 0)
                if not probes:  # the first device's probes
                    probes = tuple(
                        tuple(int(x) for x in to_host_ns([c.probe_begin_ns, c.probe_end_ns], recs.clock, last))
                        for c in (recs.clock, last) if c is not None and c.probe_begin_ns)
            else:
                spans = None
        s.summary = reduce_records(
            np.concatenate(records), kinds, dropped, None if spans is None else np.concatenate(spans),
            None if spans is None else uncertainty, probes)
        s.summarized = s.launches
        return s.summary


def add_kernel_spans(path) -> int:
    """Add the latest session's traced launches to the Chrome trace at
    ``path`` (``torch.profiler``'s ``export_chrome_trace``), as complete
    events on a track of their own, one a launch from its earliest walk
    (CTA) start to its latest end, with ``launch_args`` as arguments. The
    spans are put on the trace's device timeline (``on_timeline``) where
    the trace holds a clock probe, and left on the host clock otherwise; the
    track's name says which, and the uncertainty. A ``kernel_summary()``
    read before the session ends puts a second probe in the trace. Returns
    the events added."""
    summary = kernel_summary() or {}
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    base = int(data.get("baseTimeNanoseconds", 0)) if isinstance(data, dict) else 0
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    points = timeline_points(events, next(iter(summary.values())).probes if summary else (), base)
    added = []
    for tid, (kernel, k) in enumerate(summary.items()):
        if k.spans is None:
            continue
        on = f"the device timeline, by {len(points)} clock probe(s)" if points else "the host clock"
        unc = k.uncertainty_ns + max((u for _, _, u in points), default=0)
        added.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                      "args": {"name": f"{KERNEL_NAMES[kernel]} on {on}, +- {unc} ns"}})
        for row, (start, end) in zip(k.records, on_timeline(k.spans, points).tolist()):
            added.append({"ph": "X", "cat": "kernel_span", "name": KERNEL_NAMES[kernel], "pid": pid, "tid": tid,
                          "ts": (start - base) / 1e3, "dur": (end - start) / 1e3, "args": launch_args(kernel, row)})
    if added:
        added.insert(0, {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                         "args": {"name": "kernel spans (%globaltimer)"}})
        events.extend(added)
        with open(path, "w") as f:
            json.dump(data, f)
    return len(added)
