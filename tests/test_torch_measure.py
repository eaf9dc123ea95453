"""The port's measurement tools (``scripts/{work_ledger,spec_ratio,sweep_stats,kernel_attrib,pipeline_times,validate}.py``) against the JAX side.

At small sizes on the CPU: the work ledger's counts from the port's match
lengths and from the JAX spec's (``lane_model_encode.match_search_sorted``)
on the same seeded blocks, its sweep count against a brute-force recount,
its decode count and ``bound`` against their formulas; ``spec_ratio``'s
total against the JAX ``scripts/spec_ratio.py::measure`` (loaded by path);
``sweep_stats``'s walk against ``utils/sweep_table.py``'s counts;
``validate --device cpu`` against the JAX runtime's ``pallas`` stream
(interpret mode); the card-only tools exit non-zero without a GPU; the
new modules import with JAX blocked. The tools' runs on the card are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 21.
"""

from __future__ import annotations

import ast
import collections
import hashlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pim_compression_tpu import runtime as ref_runtime
from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.ops import hopper_match, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import kernel_attrib, spec_ratio, sweep_stats, validate, work_ledger
from pim_compression_tpu_torch.utils import streams, sweep_table

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# Spec-style configs (match_search_sorted's keywords): the zero-flag config,
# the sel_all ladder at prev_k 2, and a strided sel_all ladder.
SPEC_CONFIGS = {
    "zero-flag": "rungs=4,16 rung_pick=1 ext_cap=48 neighbor=1 max_lag=8192",
    "sel_all-prev2": "rungs=4 prev_k=2 sel_cap=16 sel_all=1",
    "strided": "rungs=4,32 prev_k=2 rung_strides=1,8 sel_cap=16 sel_all=1",
}


def _jax_module(name: str, path: pathlib.Path):
    """A JAX-side script loaded from ``path`` under a name of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _text_blocks(nb: int, bs: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """nb blocks of seeded text, the last one partial."""
    text = streams.text_payload(nb * bs - bs // 3, seed)
    return pipeline.blockize_plain(text, bs)


# ---------------------------------------------------------------------------
# The work ledger.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs", [1024, 4096])
@pytest.mark.parametrize("name", sorted(SPEC_CONFIGS))
def test_ledger_match_count_from_the_port_equals_from_the_spec(name, bs):
    cfg = spec_ratio.parse_config(SPEC_CONFIGS[name])
    blocks, lens = _text_blocks(4, bs, 11 + bs)
    knobs = work_ledger.reference_knobs(dict(cfg, block_size=bs))
    assert knobs.pop("matcher") == "sorted"
    mlen, _ = hopper_match.match_blocks(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
    spec_len, _ = lme.match_search_sorted(blocks.T.astype(np.int32), lens, **cfg)
    spec_len = torch.from_numpy(spec_len.T.astype(np.uint8).copy())
    assert torch.equal(mlen, spec_len)
    ours, theirs = work_ledger.match_work(mlen, knobs), work_ledger.match_work(spec_len, knobs)
    assert ours == theirs and ours["ops"] > len(lens) * bs


def _first_word_pairs(blocks, lens, mlen, mlag, window: int, coarse: int, granular: bool) -> int:
    """The (position, lag) pairs whose first words match, position by
    position: every fine lag up to the window, then the coarse lags (every
    8th sampled; every one at 8-aligned positions with 8 bytes left,
    granular), up to the lag of a match as long as the position's remaining
    length allows."""
    total = 0
    for b in range(len(lens)):
        n = int(lens[b])
        data = np.zeros(blocks.shape[1] + 3, np.int64)
        data[:n] = blocks[b, :n]
        word = data[:-3] | data[1:-2] << 8 | data[2:-1] << 16 | data[3:] << 24
        for p in range(n - 3):
            words = min(16, (n - p) // 4)
            top = max(length for k, length in ((0, 0), (1, 4), (2, 8), (4, 16), (8, 32), (16, 64)) if words >= k)
            last = int(mlag[b, p]) if mlen[b, p] and mlen[b, p] == top else blocks.shape[1]
            lags = list(range(1, min(window, p) + 1))
            if coarse > window and (not granular or (p % 8 == 0 and n - p >= 8)):
                lags += range(window + (1 if granular else 8), min(coarse, p) + 1, 1 if granular else 8)
            lags = np.array([d for d in lags if d <= last], np.int64)
            total += int((word[p - lags] == word[p]).sum()) if len(lags) else 0
    return total


@pytest.mark.parametrize("granular", [False, True])
def test_ledger_sweep_first_word_pairs_equal_a_recount(granular):
    bs = 1024
    blocks, lens = _text_blocks(3, bs, 5)
    knobs = hopper_sweep.sweep_knobs(bs, 256, 1024, granular)
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    mlen, mlag = hopper_sweep.sweep_match(b, n, **knobs)
    work = work_ledger.sweep_work(b, n, mlen, mlag, knobs)
    want = _first_word_pairs(blocks, lens, mlen.numpy(), mlag.numpy(), knobs["window"], knobs["coarse_window"],
                             knobs["granular"])
    assert work["first_word_pairs"] == want > 0
    assert work["ops"] == len(lens) * bs + want
    assert work["visited_pairs"] >= want and work["visited_bound"]["ops"] == work["visited_pairs"]


def test_ledger_decode_count_is_the_plaintext():
    bs = 4096
    plain = streams.text_payload(5 * bs + 777, 3)
    stream = native.compress(plain, bs)
    _, clen, olen = pipeline.blockize_compressed(stream, pipeline.scan_frames(stream))
    work = work_ledger.decode_work(clen, olen, bs)
    assert work["ops"] == int(olen.sum()) == len(plain)
    assert work["bytes"] == int(clen.sum()) + 8 * 6 + 6 * bs + 4 * 6


@pytest.mark.parametrize("nbytes, ops", [(10**9, 0), (0, 10**12), (3 * 10**8, 10**10), (1, 1)])
def test_bound_is_its_formula_at_the_stated_rates(nbytes, ops):
    got = work_ledger.bound(nbytes, ops)
    bytes_ms = nbytes / 3.35e12 * 1e3
    ops_ms = ops / (132 * 128 * 1.98e9) * 1e3
    assert got["bound_ms"] == max(bytes_ms, ops_ms)
    assert got["bound_by"] == ("bytes" if bytes_ms >= ops_ms else "operations")
    assert (got["bytes"], got["ops"]) == (nbytes, ops)


def test_ledger_tool_on_the_cpu(tmp_path):
    out = tmp_path / "ledger.json"
    argv = ["--device", "cpu", "--blocks", "2", "--config", "8192 sweep", "--config", "encode bs=8192 sorted",
            "--decode-sizes", "8192", "--out", str(out)]
    assert work_ledger.main(argv) == 0
    ledger = json.loads(out.read_text())
    assert ledger["device"] == "cpu"
    rows = {(r["kernel"], r["config"]): r for r in ledger["rows"]}
    assert set(rows) == {("decode", "8192 decode"), ("sweep", "8192 sweep"), ("emit", "8192 sweep"),
                         ("match", "encode bs=8192 sorted"), ("emit", "encode bs=8192 sorted")}
    for r in rows.values():
        assert r["blocks"] == 2 and r["payload_bytes"] == 2 * 8192
        assert r["ceiling_gbps"] == pytest.approx(r["payload_bytes"] / r["bound_ms"] / 1e6)
        assert r["bound_ms"] == work_ledger.bound(r["bytes"], r["ops"])["bound_ms"]


def test_ledger_configs_are_the_op_ledgers():
    # op_ledger.py's encode configs, read from its source: the same list, in order.
    source = (REPO / "scripts" / "op_ledger.py").read_text()
    node = next(n for n in ast.walk(ast.parse(source))
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "enc_cfgs")
    assert eval(ast.get_source_segment(source, node.value), {"dict": dict}) == work_ledger.REFERENCE_CONFIGS
    assert len(work_ledger.configs("reference")) == len(work_ledger.REFERENCE_CONFIGS) == 30
    knobs = work_ledger.reference_knobs(dict(block_size=32768, matcher="sorted"))
    assert knobs == dict(matcher="sorted", rungs=(4, 8, 16, 32, 64), ext_cap=64, neighbor=False, max_lag=0,
                         prev_k=1, sel_cap=0, sel_all=False, rung_pick=False, strides=(1,) * 5, sort_window=0)
    with pytest.raises(ValueError, match="rung_windows"):
        work_ledger.reference_knobs(dict(block_size=32768, rung_windows=(512,)))


# ---------------------------------------------------------------------------
# The ratio tool.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPEC_CONFIGS))
def test_spec_ratio_total_equals_the_jax_measure(name):
    ref = _jax_module("jax_spec_ratio", REPO / "scripts" / "spec_ratio.py")
    plain = streams.text_payload(90_000, 7)
    cs = SPEC_CONFIGS[name]
    assert spec_ratio.parse_config(cs) == ref.parse_config(cs)
    for bs in (1024, 4096):
        want, _ = ref.measure(plain, bs, ref.parse_config(cs))
        got, _ = spec_ratio.measure(plain, bs, spec_ratio.parse_config(cs), engine="torch")
        assert got == want


def test_spec_ratio_prints_the_jax_line(tmp_path, capsys):
    # A corpus of one file, xml, shipped as .txt and .snappy.
    text = streams.text_payload(50_000, 4)
    (tmp_path / "xml.txt").write_bytes(text)
    (tmp_path / "xml.snappy").write_bytes(native.compress(text, 4096))
    cs = "rungs=4,16 rung_pick=1"
    assert spec_ratio.main(["--bs", "4096", "--engine", "torch", "--corpus", str(tmp_path), "--config", cs]) == 0
    total, _ = spec_ratio.measure(text, 4096, spec_ratio.parse_config(cs), engine="torch")
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"xml        bs=4096 [{cs}] -> {total} bytes, ratio {1 - total / len(text):.4f} (")


# ---------------------------------------------------------------------------
# The census.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window, coarse, granular", [(256, 0, False), (256, 1024, False), (512, 2048, True)])
def test_sweep_stats_walk_equals_the_mirrors_counts(window, coarse, granular):
    bs = 2048
    blocks, lens = _text_blocks(2, bs, 9)
    knobs = hopper_sweep.sweep_knobs(bs, window, coarse, granular)
    rec = sweep_stats.sweep_point(blocks, lens, knobs, torch.device("cpu"))
    stats = collections.Counter()
    sweep_table.sweep_table(blocks, lens, knobs["window"], knobs["coarse_window"], knobs["granular"], stats=stats)
    assert rec["entries_walked"] == stats["lane_steps"] + sweep_table.LANES * stats["rounds"]
    assert rec["walks"] == stats["walks"] and rec["handed_off_share"] == stats["handed_off"] / stats["walks"]
    assert rec["entries_per_walk"]["max"] >= rec["entries_per_walk"]["p99"] >= 1


def test_sweep_stats_extension_trips_follow_the_kernels_loop():
    # A block of 'ab' repeated: every position from 2 on matches at lag 2.
    bs = 256
    blocks = np.frombuffer(b"ab" * (bs // 2), np.uint8).reshape(1, bs).copy()
    lens = np.array([200], np.int32)
    data = torch.where(torch.arange(bs)[None, :] < torch.from_numpy(lens)[:, None], torch.from_numpy(blocks), 0)
    w4 = hopper_match._word4(data.long())
    cand = torch.where(torch.arange(bs)[None, :] >= 2, 2, 0)
    trips = sweep_stats.extend_trips(w4, torch.from_numpy(lens), cand, 48)[0]
    # ceil(min(48, 200 - p) / 4) trips: whole words equal up to the cap or
    # the block's length; none before p = 2 or past the length.
    want = [0, 0] + [-(-min(48, 200 - p) // 4) for p in range(2, 200)] + [0] * (bs - 200)
    assert trips.tolist() == want


def test_sweep_stats_runs_on_the_cpu():
    census = sweep_stats.run("cpu", blocks=1, grid=[(512, 4096, "granular")], sweep_sizes=(8192,), max_lags=(8192,),
                             ext_caps=(48,))
    (sweep,), (srt,) = census["sweep"], census["sorted"]
    assert sweep["positions"] == 8192 and 0 < sweep["handed_off_share"] < 1
    assert srt["max_lag"] == 8192 and 0 < srt["candidate_share"][4] <= 1
    assert sum(r["share"] for r in srt["by_winning_rung"].values()) <= 1


# ---------------------------------------------------------------------------
# Validation, attribution, and the card-only tools.
# ---------------------------------------------------------------------------


def test_validate_on_the_cpu_gives_the_jax_runtimes_stream():
    flags = ["--bs", "1024", "--blocks", "8", "--matcher", "sorted", "--rungs", "4,16", "--rung-pick",
             "--neighbor", "--ext-cap", "48", "--max-lag", "8192", "--iters", "1", "--device", "cpu"]
    args = validate.parse(flags)
    res = validate.run(args)
    assert res["kernels"] is False and res["engine"] == "torch" and res["device"] == "cpu"
    assert res["decode_bit_exact"] and res["encode_round_trip"] and res["encode_decodes_ok"]
    cfg = CodecConfig(engine="pallas", block_size=1024, matcher="sorted", rungs=(4, 16), rung_pick=True,
                      neighbor=True, ext_cap=48, max_lag=8192, batch_blocks=8)
    stream = bytes(ref_runtime.compress(validate.workload(args), cfg))
    assert res["stream_sha256"] == hashlib.sha256(stream).hexdigest() and res["stream_bytes"] == len(stream)


class _Event:
    def __init__(self, t: float):
        self.t = t

    def elapsed_time(self, other) -> float:
        return other.t - self.t


def test_kernel_attrib_spans_cover_the_call():
    marks = [("match", _Event(1.0)), ("match", _Event(4.0)), ("emit", _Event(4.5)), ("emit", _Event(6.0))]
    spans = kernel_attrib._spans(_Event(0.0), marks, _Event(6.25))
    assert spans == [("glue before match", 1.0), ("match", 3.0), ("glue match -> emit", 0.5), ("emit", 1.5),
                     ("glue after emit", 0.25)]
    assert kernel_attrib._spans(_Event(0.0), [], _Event(2.0)) == [("glue", 2.0)]


@pytest.mark.parametrize("tool", ["kernel_attrib", "pipeline_times", "validate"])
def test_card_only_tools_exit_non_zero_without_a_gpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", f"pim_compression_tpu_torch.scripts.{tool}"], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert not (tmp_path / "build").exists()


def test_measurement_tools_import_without_jax():
    names = ["work_ledger", "kernel_attrib", "pipeline_times", "spec_ratio", "sweep_stats", "validate"]
    code = (
        "import importlib, sys\n"
        "for blocked in ('jax', 'jaxlib', 'pim_compression_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module('pim_compression_tpu_torch.scripts.' + name)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
