"""The codec kernels' spans and counters on the host side (``runtime/profiling.py``), on the CPU.

The traced kernels run only on the card (``tests/test_torch_cuda.py``).
Here: the reduction of hand-made records, the clock's calibration
arithmetic, the switch in each entry (a profiler session, ``KERNEL_SPANS``),
the session's records and their capacity, the trace export, the eight
per-layer readers of ``hopper_bench/metrics/`` on a planted summary and on
none, and their manifest entries.
"""

from __future__ import annotations

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from hopper_bench.core import cells, trace
from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.runtime import profiling

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

W = profiling.RECORD_WORDS
NEW_METRICS = ("decode_walk_balance", "decode_general_share", "decode_row_copy_share", "emit_walk_balance",
               "match_sort_ms")
SWEEP_METRICS = ("sweep_walk_ms", "sweep_entries_per_pos")
LOOKUP_METRICS = ("match_lookup_ms",)


def _record(start, end, span, count, *counters):
    """One launch's record as a kernel leaves it: ~start kept, its counters after the span's four words."""
    row = np.zeros(W, np.int64)
    row[:4] = [~start, end, span, count]
    row[4 : 4 + len(counters)] = counters
    return row


# Two decode launches, one match launch, one emit launch.
RECORDS = np.stack([
    _record(1000, 1500, 800, 2, 10, 3, 100, 5),  # walks of 400 ns each in a 500 ns launch
    _record(3000, 4000, 3000, 4, 30, 1, 300, 0),
    # Phases add to the total; then the warps' cycles in the 64 KB lookup, the lookups, their hits.
    _record(5000, 5600, 1100, 2, 10, 20, 30, 40, 50, 150, 960, 12, 5),
    _record(7000, 7100, 100, 1),
])
KINDS = ["decode", "decode", "match", "emit"]
# Two sweep launches: CTA-cycles in stage, sort, ranks, lanes, rounds and all,
# then positions walked, lane entries, positions handed off, round entries
# (32 a round) and entries past the window.
SWEEP_RECORDS = np.stack([
    _record(9000, 9800, 1500, 2, 10, 20, 5, 40, 25, 100, 60, 300, 3, 96, 12),
    _record(11000, 11400, 700, 2, 10, 20, 5, 50, 15, 100, 40, 200, 0, 0, 0),
])


def test_reduction_of_hand_made_records():
    s = profiling.reduce_records(RECORDS, KINDS, dropped={"decode": 3})
    d, m, e = s["decode"], s["match"], s["emit"]
    assert (d.launches, d.dropped, d.walks, d.span_ns) == (2, 3, 6, 3800)
    assert d.window_ns == 2 * 500 + 4 * 1000
    assert d.walk_balance == pytest.approx(3800 / 5000)
    assert d.counters == {"elements": 40, "general": 4, "copied": 400, "from_row": 5}
    assert d.share("general", "elements") == pytest.approx(0.1)
    assert d.share("from_row", "copied") == pytest.approx(5 / 400)
    assert m.counters == {"stage": 10, "sort": 20, "lags": 30, "select": 40, "fold": 50, "total": 150,
                          "lookup": 960, "lookups": 12, "hits": 5}
    assert sum(m.counters[p] for p in profiling.MATCH_PHASES) == m.counters["total"]
    assert m.share("sort", "total") == pytest.approx(20 / 150) and m.walks == 2
    assert e.counters == {} and e.walk_balance == pytest.approx(1.0)
    assert d.spans is None and d.uncertainty_ns is None
    np.testing.assert_array_equal(profiling.launch_spans(RECORDS)[:, 0], [1000, 3000, 5000, 7000])


def test_reduction_of_a_sweep_record():
    k = profiling.reduce_records(SWEEP_RECORDS, ["sweep", "sweep"])["sweep"]
    assert (k.launches, k.walks, k.span_ns, k.window_ns) == (2, 4, 2200, 2 * 800 + 2 * 400)
    assert k.counters == {"stage": 20, "sort": 40, "ranks": 10, "lanes": 90, "rounds": 40, "total": 200,
                          "positions": 100, "lane_entries": 500, "handed": 3, "round_entries": 96,
                          "coarse_entries": 12}
    assert sum(k.counters[p] for p in profiling.SWEEP_PHASES) == k.counters["total"]
    assert k.share("lanes", "total") == pytest.approx(0.45) and k.share("rounds", "total") == pytest.approx(0.2)
    args = profiling.launch_args("sweep", SWEEP_RECORDS[0])
    assert args["ctas"] == 2 and args["lanes_%"] == pytest.approx(40.0) and args["handed"] == 3
    assert "sort_%" in args and "lags_%" not in args  # the sweep's own phases


def test_reduction_of_nothing_reads_none():
    empty = np.zeros((2, W), np.int64)  # records taken, no walk wrote them
    s = profiling.reduce_records(empty, ["decode", "emit"], dropped={"match": 1})
    assert s["decode"].walk_balance is None and s["decode"].share("general", "elements") is None
    assert s["match"].launches == 0 and s["match"].dropped == 1 and s["match"].share("sort", "total") is None
    np.testing.assert_array_equal(profiling.launch_spans(empty), 0)
    assert profiling.reduce_records(np.zeros((0, W), np.int64), []) == {}


def test_launch_args_of_one_record():
    assert profiling.launch_args("decode", RECORDS[0]) == {
        "walks": 2, "walk_balance_%": 80.0, "elements": 10, "general": 3, "copied": 100, "from_row": 5}
    args = profiling.launch_args("match", RECORDS[2])
    assert args["ctas"] == 2 and args["sort_%"] == pytest.approx(13.333, abs=1e-3) and args["total"] == 150
    assert (args["lookup"], args["lookups"], args["hits"]) == (960, 12, 5) and "lookup_%" not in args


def test_clock_calibration_arithmetic():
    # Host readings around each %globaltimer reading; the tightest try wins.
    point = profiling.tightest([[100, 5000, 140], [200, 5100, 210], [300, 5200, 360]])
    assert (point.device_ns, point.host_ns, point.uncertainty_ns) == (5100, 205, 5)
    np.testing.assert_array_equal(profiling.to_host_ns([5100, 6100], point), [205, 1205])
    # A second calibration 1e9 ns later, 1000 ns of drift: interpolated.
    later = profiling.ClockPoint(device_ns=5100 + 10**9, host_ns=205 + 10**9 - 1000, uncertainty_ns=3)
    np.testing.assert_array_equal(
        profiling.to_host_ns([5100, 5100 + 5 * 10**8, 5100 + 10**9], point, later),
        [205, 205 + 5 * 10**8 - 500, 205 + 10**9 - 1000])
    # Readings on the unix clock stay exact in int64.
    big = profiling.ClockPoint(device_ns=1_792_000_000_123_456_789, host_ns=1_792_000_000_000_000_001,
                               uncertainty_ns=1)
    assert int(profiling.to_host_ns([big.device_ns + 7], big)[0]) == big.host_ns + 7


@pytest.fixture
def fresh(monkeypatch):
    """No session yet, and every entry's launch replaced: it records the trace argument."""
    monkeypatch.setattr(profiling, "_session", None)
    monkeypatch.setattr(profiling, "KERNEL_SPANS", None)
    launched = []
    for module in (hopper_decode, hopper_match, hopper_sweep, hopper_encode):
        monkeypatch.setattr(module, "_launch", lambda *args: launched.append(args[-1]))
    return launched


def _entries(on_card: bool, monkeypatch):
    """Call each entry once on small CPU tensors, as if they were on the card where ``on_card``."""
    for module in (hopper_decode, hopper_match, hopper_sweep, hopper_encode):
        if on_card:
            monkeypatch.setattr(module, "_on_card", lambda *args: True)
    blocks = torch.zeros((2, 256), dtype=torch.uint8)
    lens = torch.full((2,), 256, dtype=torch.int32)
    hopper_decode.decode_blocks(blocks, torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                                block_size=256)
    hopper_match.match_blocks(blocks, lens, rungs=(4,), max_lag=0)
    hopper_sweep.sweep_match(blocks, lens, window=64)
    hopper_encode.emit_blocks(blocks, lens, torch.zeros((2, 256), dtype=torch.uint8),
                              torch.zeros((2, 256), dtype=torch.int16), 512)


def _span_names(prof) -> list:
    return sorted({e.name for e in prof.events() if re.match(r"^((decode|match|emit)_blocks|sweep_match)\.", e.name)})


def test_off_without_a_profiler(fresh, monkeypatch):
    monkeypatch.setattr(profiling, "launch_record", lambda *a: pytest.fail("a record was taken"))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: pytest.fail("a span was opened"))
    _entries(True, monkeypatch)
    assert fresh == [None, None, None, None]  # the plain kernels
    assert profiling._session is None and profiling.kernel_summary() is None


def test_on_inside_a_profiler(fresh, monkeypatch):
    with torch.profiler.profile() as prof:
        _entries(True, monkeypatch)
    entries = ("decode_blocks", "emit_blocks", "match_blocks", "sweep_match")
    assert _span_names(prof) == [f"{e}.{p}" for e in entries for p in ("alloc", "check", "launch")]
    assert all(isinstance(t, int) and t for t in fresh) and len(set(fresh)) == 4
    assert fresh[1] - fresh[0] == fresh[2] - fresh[1] == fresh[3] - fresh[2] == 8 * W  # one record after another
    recs = profiling._session.devices[torch.device("cpu")]
    assert recs.kinds == ["decode", "match", "sweep", "emit"] and recs.buffer.shape == (profiling.CAPACITY, W)
    summary = profiling.kernel_summary()
    assert set(summary) == {"decode", "match", "sweep", "emit"} and summary["decode"].walks == 0
    assert summary["decode"].walk_balance is None  # the stand-in launches wrote nothing


def test_off_with_kernel_spans_false(fresh, monkeypatch):
    monkeypatch.setattr(profiling, "KERNEL_SPANS", False)
    monkeypatch.setattr(profiling, "launch_record", lambda *a: pytest.fail("a record was taken"))
    with torch.profiler.profile() as prof:
        _entries(True, monkeypatch)
    assert _span_names(prof) == [] and fresh == [None, None, None, None]


def test_cpu_tensors_take_no_record_inside_a_profiler(fresh, monkeypatch):
    monkeypatch.setattr(profiling, "launch_record", lambda *a: pytest.fail("a record was taken"))
    with torch.profiler.profile() as prof:
        _entries(False, monkeypatch)
    assert _span_names(prof) == ["decode_blocks.check", "emit_blocks.check", "match_blocks.check", "sweep_match.check"]
    assert fresh == [] and profiling.kernel_summary() is None


def test_a_full_buffer_drops_launches_and_a_new_session_starts_over(fresh, monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 2)
    with torch.profiler.profile():
        got = [profiling.launch_record(k, "cpu") for k in ("decode", "decode", "decode", "match")]
    assert got[0] and got[1] and got[2:] == [None, None]
    s = profiling.kernel_summary()
    assert (s["decode"].launches, s["decode"].dropped, s["match"].launches, s["match"].dropped) == (2, 1, 0, 1)
    assert profiling.kernel_summary() is s  # kept until the session traces another launch
    with torch.profiler.profile():
        pass
    assert profiling.kernel_summary() is None  # the latest session traced nothing
    with torch.profiler.profile():
        profiling.launch_record("emit", "cpu")
    assert set(profiling.kernel_summary()) == {"emit"}


def _probe_event(start_ns: int, dur_ns: int, base: int) -> dict:
    return {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::clock_probe_kernel(Probe volatile*, int)",
            "pid": 0, "tid": 7, "ts": (start_ns - base) / 1e3, "dur": dur_ns / 1e3}


def test_timeline_points_find_each_probe_on_the_device_timeline():
    base = 1_790_000_000_000_000_000
    first, last = (base + 1_000_000, base + 1_060_000), (base + 101_000_000, base + 101_060_000)
    events = [
        _probe_event(base + 900_000_000, 60_000, base),  # another session's probe, 0.9 s away
        _probe_event(base + 1_050_000, 62_000, base),  # the first, 50 us later, 2 us longer
        _probe_event(base + 101_070_000, 60_000, base),  # the last, 70 us later
    ]
    points = profiling.timeline_points(events, (first, last), base)
    assert points == [(first[0], 51_000, 1_000), (last[0], 70_000, 0)]
    assert profiling.timeline_points(events[:1], (first,), base) == []  # more than 1 ms away
    # A probe whose own event is missing takes no other's, even one within 1 ms.
    close = (base + 1_500_000, base + 1_560_000)
    assert profiling.timeline_points(events[1:2], (first, close), base) == [(first[0], 51_000, 1_000)]
    assert profiling.timeline_points([dict(events[1], cat="cpu_op")], (first,), base) == []
    assert profiling.timeline_points(events, (), base) == []
    # One point shifts every span by its shift; two interpolate in host time.
    spans = np.array([[base + 1_000_000, base + 51_000_000]])
    np.testing.assert_array_equal(profiling.on_timeline(spans, points[:1]), spans + 51_000)
    np.testing.assert_array_equal(profiling.on_timeline(spans, points), spans + [[51_000, 60_500]])
    np.testing.assert_array_equal(profiling.on_timeline(spans, []), spans)


def test_trace_export_adds_a_track(fresh, monkeypatch, tmp_path):
    base = 1_790_000_000_000_000_000
    spans = np.array([[base + 2_000_000, base + 2_500_000]] * 2 + [[base + 3_000_000, base + 3_600_000]]
                     + [[base + 4_000_000, base + 4_100_000]], np.int64)
    summary = profiling.reduce_records(RECORDS, KINDS, spans=spans, uncertainty_ns=700,
                                       probes=((base + 1_000_000, base + 1_060_000),))
    monkeypatch.setattr(profiling, "kernel_summary", lambda: summary)
    path = tmp_path / "trace.json"
    kernel = {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": 1000.0, "dur": 5.0}
    for events, shift in (([kernel], 0.0), ([kernel, _probe_event(base + 1_040_000, 60_000, base)], 40.0)):
        path.write_text(json.dumps({"baseTimeNanoseconds": base, "traceEvents": events}))
        assert profiling.add_kernel_spans(path) == 1 + 3 + 4  # the process, a track a kernel, a launch each
        out = json.loads(path.read_text())["traceEvents"]
        launches = [e for e in out if e.get("cat") == "kernel_span"]
        assert [e["name"] for e in launches] == ["decode_blocks_kernel"] * 2 + ["match_blocks_kernel",
                                                                               "emit_blocks_kernel"]
        assert launches[0]["ts"] == 2000.0 + shift and launches[0]["dur"] == 500.0 and launches[0]["pid"] == 1
        assert launches[2]["args"]["sort_%"] == pytest.approx(13.333, abs=1e-3)
        tracks = [e["args"]["name"] for e in out if e.get("name") == "thread_name"]
        assert all(("device timeline" in t) == bool(shift) for t in tracks)
    monkeypatch.setattr(profiling, "kernel_summary", lambda: None)
    assert profiling.add_kernel_spans(path) == 0


# -- the readers --------------------------------------------------------

DECOMPRESS, COMPRESS = "bs32k_sorted.device_decompress", "bs32k_sorted.device_compress"
SWEEP, LADDER = "bs8k_sweep.device_compress", "bs64k_ladder.device_compress"


def _cell_of(metric: str) -> str:
    if metric in LOOKUP_METRICS:
        return LADDER
    return DECOMPRESS if metric.startswith("decode") else SWEEP if metric.startswith("sweep") else COMPRESS


def _read(metric: str, cell: str, monkeypatch, summary, calls: int = 4000, ops=None):
    c = cells.load_cell(cell)
    monkeypatch.setattr(profiling, "kernel_summary", lambda: summary)
    record = cells.load_driver(c).Record(entry=c.traffic["entry"], calls=calls, window_s=10.0, enqueue_s=[],
                                         function_bytes=0)
    if ops is not None:
        record.trace = trace.Summary(window_s=10.0, busy_s=9.9, device_s=sum(v for _, v in ops), device_ops=ops,
                                     idle_gaps=[])
    return cells.load_reader(c, metric)(record)


MATCH_OPS = [["void (anonymous namespace)::match_blocks_kernel<true>(unsigned char const*, ...)", 8.0],
             ["void (anonymous namespace)::emit_blocks_kernel<true>(unsigned char const*, ...)", 2.0]]
SWEEP_OPS = [["void (anonymous namespace)::sweep_blocks_kernel<2, true>(unsigned char const*, ...)", 6.0],
             ["void (anonymous namespace)::emit_blocks_kernel<true>(unsigned char const*, ...)", 2.0]]


def test_readers_on_a_planted_summary(monkeypatch):
    s = profiling.reduce_records(RECORDS, KINDS)
    assert _read("decode_walk_balance", DECOMPRESS, monkeypatch, s) == pytest.approx(76.0)
    assert _read("decode_general_share", DECOMPRESS, monkeypatch, s) == pytest.approx(10.0)
    assert _read("decode_row_copy_share", DECOMPRESS, monkeypatch, s) == pytest.approx(1.25)
    assert _read("emit_walk_balance", COMPRESS, monkeypatch, s) == pytest.approx(100.0)
    # 8 s of match over 4000 calls is 2 ms a call; 20 of its 150 CTA-cycles sort.
    assert _read("match_sort_ms", COMPRESS, monkeypatch, s, ops=MATCH_OPS) == pytest.approx(2.0 * 20 / 150)
    # 960 of the 32 warps' 32 x 150 cycles in the lookup.
    assert _read("match_lookup_ms", LADDER, monkeypatch, s, ops=MATCH_OPS) == pytest.approx(2.0 * 960 / (32 * 150))
    # 6 s of sweep over 4000 calls is 1.5 ms a call; 130 of its 200 CTA-cycles walk.
    sw = profiling.reduce_records(np.concatenate([RECORDS, SWEEP_RECORDS]), KINDS + ["sweep", "sweep"])
    assert _read("sweep_walk_ms", SWEEP, monkeypatch, sw, ops=SWEEP_OPS) == pytest.approx(1.5 * 130 / 200)
    assert _read("sweep_entries_per_pos", SWEEP, monkeypatch, sw) == pytest.approx((500 + 96) / 100)
    assert _read("emit_walk_balance", SWEEP, monkeypatch, sw) == pytest.approx(100.0)


@pytest.mark.parametrize("metric", NEW_METRICS + SWEEP_METRICS + LOOKUP_METRICS)
def test_readers_read_none_where_nothing_was_recorded(metric, monkeypatch):
    cell = _cell_of(metric)
    empty = profiling.reduce_records(np.zeros((4, W), np.int64), ["decode", "match", "sweep", "emit"])
    for summary in (None, {}, empty):
        assert _read(metric, cell, monkeypatch, summary, ops=MATCH_OPS) is None
    # A summary of the other direction's kernels reads nothing either.
    compress = cell in (COMPRESS, LADDER)
    other = profiling.reduce_records(RECORDS[[0, 1]] if compress else RECORDS[[2, 3]],
                                     ["decode"] * 2 if compress else ["match", "emit"])
    assert _read(metric, cell, monkeypatch, other, ops=MATCH_OPS) is None
    if cell == SWEEP:  # a program whose traced encode ran no sweep kernel (the sorted matcher's)
        assert _read(metric, cell, monkeypatch, profiling.reduce_records(RECORDS, KINDS), ops=MATCH_OPS) is None


def test_sweep_walk_ms_needs_the_trace(monkeypatch):
    sw = profiling.reduce_records(SWEEP_RECORDS, ["sweep", "sweep"])
    assert _read("sweep_walk_ms", SWEEP, monkeypatch, sw) is None  # no trace
    assert _read("sweep_walk_ms", SWEEP, monkeypatch, sw, ops=SWEEP_OPS[1:]) is None  # no sweep kernel in it
    assert _read("sweep_walk_ms", SWEEP, monkeypatch, sw, calls=0, ops=SWEEP_OPS) is None


def test_match_lookup_ms_reads_none_without_a_lookup(monkeypatch):
    # A decompress run, an untraced run, a program whose match kernel has no
    # lookup counter (an older kernel), and a launch that looked nothing up
    # (no rung split: blocks of 32 KB or less) read nothing.
    s = profiling.reduce_records(RECORDS, KINDS)
    assert _read("match_lookup_ms", LADDER, monkeypatch, s, ops=MATCH_OPS) is not None
    decompress = cells.load_cell("bs64k_ladder.device_decompress")
    monkeypatch.setattr(profiling, "kernel_summary", lambda: s)
    record = cells.load_driver(decompress).Record(entry="decompress", calls=4000, window_s=10.0, enqueue_s=[],
                                                  function_bytes=0)
    record.trace = trace.Summary(window_s=10.0, busy_s=9.9, device_s=10.0, device_ops=MATCH_OPS, idle_gaps=[])
    assert cells.load_reader(decompress, "match_lookup_ms")(record) is None
    assert _read("match_lookup_ms", LADDER, monkeypatch, s) is None  # untraced
    older = dict(s, match=dataclasses.replace(s["match"], counters={
        k: v for k, v in s["match"].counters.items() if k not in ("lookup", "lookups", "hits")}))
    assert _read("match_lookup_ms", LADDER, monkeypatch, older, ops=MATCH_OPS) is None
    unsplit = dict(s, match=dataclasses.replace(s["match"], counters=dict(s["match"].counters, lookup=0)))
    assert _read("match_lookup_ms", LADDER, monkeypatch, unsplit, ops=MATCH_OPS) is None
    assert _read("match_lookup_ms", LADDER, monkeypatch, s, ops=MATCH_OPS[1:]) is None  # no match kernel traced


def test_match_sort_ms_needs_the_trace(monkeypatch):
    s = profiling.reduce_records(RECORDS, KINDS)
    assert _read("match_sort_ms", COMPRESS, monkeypatch, s) is None  # no trace
    assert _read("match_sort_ms", COMPRESS, monkeypatch, s, ops=MATCH_OPS[1:]) is None  # no match kernel in it
    assert _read("match_sort_ms", COMPRESS, monkeypatch, s, calls=0, ops=MATCH_OPS) is None


def test_readers_of_a_program_without_kernel_spans(monkeypatch):
    # A program without kernel spans has no kernel_summary: the readers read nothing.
    monkeypatch.delattr(profiling, "kernel_summary")
    for metric in NEW_METRICS + SWEEP_METRICS + LOOKUP_METRICS:
        c = cells.load_cell(_cell_of(metric))
        record = cells.load_driver(c).Record(entry=c.traffic["entry"], calls=1, window_s=1.0, enqueue_s=[],
                                             function_bytes=0)
        assert cells.load_reader(c, metric)(record) is None


# -- the manifest ---------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_entries_of_the_kernel_metrics():
    spec = cells.load_json(cells.MANIFEST)
    per_layer = spec["per_layer"]
    kernel_metrics = NEW_METRICS + SWEEP_METRICS + LOOKUP_METRICS
    assert [m["name"] for m in per_layer[-len(kernel_metrics):]] == list(kernel_metrics)  # appended, in order
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells_by_name = {w["name"] for w in spec["workloads"]}
    names = [m["name"] for m in spec["end_to_end"] + per_layer]
    assert len(names) == len(set(names))
    # The cells whose kernels each metric reads: the decode's, the match kernel's, the sweep's, the emit's.
    decompress = {"bs32k_sorted.device_decompress", "bs64k_ladder.device_decompress"}
    sorted_compress = {"bs32k_sorted.device_compress", "bs64k_ladder.device_compress"}
    runs = {"decode": decompress, "match": sorted_compress, "sweep": {SWEEP}, "emit": sorted_compress | {SWEEP}}
    units = {"match_sort_ms": "ms", "sweep_walk_ms": "ms", "sweep_entries_per_pos": "entries", "match_lookup_ms": "ms"}
    for m in per_layer[-len(kernel_metrics):]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("program_span", "program_counter") and m["layer"] == "kernels"
        assert m["moves"] in e2e and set(m["workloads"]) <= cells_by_name
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])  # each cell reports what it moves
        direction = "decompress" if m["name"].startswith("decode") else "compress"
        assert m["moves"] == f"{direction}_gbps"
        # The lookup runs only where a rung sorts its 32 KB halves in turn: the 64 KB cell.
        assert set(m["workloads"]) == ({LADDER} if m["name"] in LOOKUP_METRICS else runs[m["name"].split("_")[0]])
        for w in m["workloads"]:
            cell = cells.load_cell(w)
            assert m["name"] in [x["name"] for x in cell.per_layer]
            assert callable(cells.load_reader(cell, m["name"]))
        assert m["unit"] == units.get(m["name"], "%")
    assert len(json.dumps(spec)) < 64 * 1024
