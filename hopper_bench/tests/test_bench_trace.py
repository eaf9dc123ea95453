"""The reduction of a trace to busy time, idle gaps and device operations,
and the roofline and idle arithmetic of the readers, on a hand-made trace."""

from __future__ import annotations

import json

import pytest

from hopper_bench.core import cells, trace
from hopper_bench.tests.bench_tiny import make_bench, tiny_cell
from hopper_bench.yardstick import work


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


EVENTS = [
    _x("window", "user_annotation", 1000.0, 1000.0),
    _x("enqueue", "user_annotation", 1000.0, 150.0),
    _x("wait", "user_annotation", 1150.0, 850.0),
    _x("kernel_a", "kernel", 1100.0, 300.0),  # [1100, 1400]
    _x("kernel_b", "kernel", 1350.0, 250.0),  # [1350, 1600], overlaps a
    _x("Memcpy DtoD", "gpu_memcpy", 1700.0, 100.0),  # [1700, 1800]
    _x("kernel_a", "kernel", 1950.0, 100.0),  # [1950, 2050], cut at the window's end
    _x("kernel_a", "kernel", 500.0, 100.0),  # before the window
    _x("enqueue", "gpu_user_annotation", 1000.0, 900.0),  # not device work
    {"ph": "i", "name": "marker", "ts": 1500.0},
]


def test_summary_of_a_hand_made_trace():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(1000e-6)
    # busy: [1100, 1600] + [1700, 1800] + [1950, 2000] = 650 us
    assert s.busy_s == pytest.approx(650e-6)
    assert s.idle_share == pytest.approx(0.35)
    # operations' own time in the window: a 300 + 100 (cut to 50 -> 50), b 250, copy 100
    assert dict((n, v) for n, v in s.device_ops) == pytest.approx(
        {"kernel_a": 350e-6, "kernel_b": 250e-6, "Memcpy DtoD": 100e-6})
    assert s.device_s == pytest.approx(700e-6)
    # gaps: [1000, 1100] mid 1050 in enqueue; [1600, 1700] and [1800, 1950] in wait
    assert dict((n, v) for n, v in s.idle_gaps) == pytest.approx({"enqueue": 100e-6, "wait": 250e-6})


def test_no_window_or_no_device_work_reads_nothing():
    assert trace.summarize([e for e in EVENTS if e["name"] != "window"]) is None
    assert trace.summarize([e for e in EVENTS if e.get("cat") not in trace.DEVICE_CATS]) is None


def test_load_events_reads_an_exported_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert trace.summarize(trace.load_events(path)).busy_s == pytest.approx(650e-6)


def test_byte_counts_and_roofline():
    assert work.decode_bytes(10_000, 32768, 1) == 10_000 + 32768 + 12
    assert work.encode_bytes(32768, 10_000, 1) == 32768 + 10_000 + 8
    nbytes = 3.35e12 * 1e-3  # a millisecond's worth at the peak
    assert work.least_seconds(nbytes) == pytest.approx(1e-3)
    assert work.roofline_percent(nbytes, 4e-3) == pytest.approx(25.0)
    assert work.roofline_percent(nbytes, 0.0) is None


@pytest.mark.parametrize("entry", ["decompress", "compress"])
def test_readers_on_a_record(tmp_path, entry):
    bench = make_bench(tmp_path)
    cell = tiny_cell(bench, entry)
    driver = cells.load_driver(cell)
    other = "compress" if entry == "decompress" else "decompress"
    summary = trace.summarize(EVENTS)
    rec = driver.Record(entry=entry, calls=2, window_s=1.0, enqueue_s=[1e-4, 3e-4],
                        function_bytes=int(3.35e12 * 7e-6), trace=summary)
    roof = "decode_roofline" if entry == "decompress" else "encode_roofline"
    assert cells.load_reader(cell, f"enqueue_ms.{entry}")(rec) == pytest.approx(0.2)
    assert cells.load_reader(cell, f"device_idle.{entry}")(rec) == pytest.approx(35.0)
    assert cells.load_reader(cell, roof)(rec) == pytest.approx(100.0 * 7e-6 / 700e-6)
    untraced = driver.Record(entry=entry, calls=2, window_s=1.0, enqueue_s=[], function_bytes=1)
    assert cells.load_reader(cell, roof)(untraced) is None
    assert cells.load_reader(cell, f"enqueue_ms.{entry}")(untraced) is None
    rec.entry = other
    assert cells.load_reader(cell, f"device_idle.{entry}")(rec) is None
