"""Time the match kernel at the main paths' shapes and in each sort-mode config.

    python3 -m pim_compression_tpu_torch.scripts.match_time [--device cuda:0] [--parent DIR]

Runs ``csrc/match.cu`` through ``ops.hopper_match.match_blocks`` on
device-resident batches of the seeded payloads ``chip_smoke.py`` makes: one
1024-block batch at bs 32768 in the zero-flag config, one at bs 65536 in the
zero-flag config as the runtime runs it there (the ``sel_all`` ladder),
config (a) on a 1024-block batch, and configs (a)-(e) on 128 payload blocks
and the 9 hand-built ones, as ``chip_smoke.py`` phases 6, 9 and 13 do. Each
time is the mean device time of 10 back-to-back launches by CUDA events.
The traced kernel then runs the two zero-flag cases (``traced_phases``).
Writes ``build/probes/match_time.json`` and prints one JSON line.

It runs as a file too, with another checkout's package first on
``PYTHONPATH`` (``PYTHONPATH=old python3 path/to/match_time.py``), so that
two versions of the kernel are timed in one run on one card. ``--parent
DIR`` does that in turns: DIR's script and this one, each in a process of
its own with its own checkout on ``PYTHONPATH``, parent, this, this,
parent; each parent case says whether its sums equal this build's. It
writes ``build/probes/match_time_turns.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from pim_compression_tpu_torch import TorchCodecConfig
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
from pim_compression_tpu_torch.runtime import profiling
from pim_compression_tpu_torch.scripts import common
from pim_compression_tpu_torch.utils import streams

SEED = 20261016
BLOCKS = 1100  # the payloads' length in blocks, less 1000 bytes
BATCH = 1024
REPS = 10
# chip_smoke.py's SORT_MODES, as config fields.
SORT_MODES = {
    "a": (32768, dict(rungs=None, prev_k=4, sel_cap=16, stride2_min=16)),
    "b": (32768, dict(rungs=(4, 16), rung_pick=False, prev_k=6)),
    "c": (32768, dict(rungs=(4, 16), sort_window=8192)),
    "d": (32768, dict(rungs=(4, 32), prev_k=2, sel_cap=16, sel_all=True, rung_strides=(1, 8))),
    "e": (65536, dict(rungs=(4, 32), rung_strides=(1, 2), sort_window=16384)),
}


def _batch(payload: bytes, bs: int, n: int) -> np.ndarray:
    return np.frombuffer(payload[: n * bs], np.uint8).reshape(n, bs).copy()


def cases() -> list[tuple]:
    """(name, bs, config fields, blocks, lens) of each timed case, on the host."""
    payloads = {bs: streams.text_payload(BLOCKS * bs - 1000, SEED) for bs in (32768, 65536)}
    out = []
    for bs in (32768, 65536):
        out.append((f"{bs} zero-flag", bs, {}, _batch(payloads[bs], bs, BATCH), np.full(BATCH, bs, np.int32)))
    for name, (bs, fields) in SORT_MODES.items():
        hb, hl = streams.hand_plain_blocks(bs, SEED)
        blocks = np.concatenate([_batch(payloads[bs], bs, 128), hb])
        out.append((f"config ({name})", bs, fields, blocks, np.concatenate([np.full(128, bs, np.int32), hl])))
    a_bs, a_fields = SORT_MODES["a"]
    out.append(("config (a)", a_bs, a_fields, _batch(payloads[a_bs], a_bs, BATCH), np.full(BATCH, a_bs, np.int32)))
    return out


def time_cases(dev, todo, check=None) -> list[dict]:
    """Mean device ms of REPS launches of match_blocks on each case, and
    each case's (mlen, mlag); with ``check`` (such outputs of another
    build) each record says whether its output equals the other's."""
    records, outputs = [], []
    for k, (name, bs, fields, blocks_np, lens_np) in enumerate(todo):
        knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs, **fields))
        blocks, lens = torch.from_numpy(blocks_np).to(dev), torch.from_numpy(lens_np).to(dev)
        kept = []
        ms = common.event_seconds(lambda: kept.append(hopper_match.match_blocks(blocks, lens, **knobs)), REPS) * 1e3
        mlen, mlag = kept[0]  # sums that two versions of the kernel must share
        rec = {"case": name, "bs": bs, "blocks": len(blocks_np), "ms": ms,
               "len_sum": int(mlen.long().sum()), "lag_sum": int((mlag.long() & 0xFFFF).sum())}
        if check is not None:
            rec["equal"] = bool(torch.equal(mlen, check[k][0]) and torch.equal(mlag, check[k][1]))
        records.append(rec)
        outputs.append((mlen, mlag))
        del kept
    return records, outputs


def traced_phases(dev, todo) -> list[dict]:
    """The traced kernel (its ``kTrace`` instantiation) on each zero-flag
    case: mean device ms of REPS launches, each with a zeroed record of its
    own, the share of the CTA-cycles in each phase (``profiling.MATCH_PHASES``)
    and the sort's ms as the benchmark's ``match_sort_ms`` reads it (the
    traced ms x sort / all); where a rung sorts its 32 KB halves in turn,
    the lookup's ms as ``match_lookup_ms`` reads it (the traced ms x the
    warps' lookup cycles / (32 warps x all)), the lookups per second-half
    position of the split rungs and the share of lookups that hit."""
    out = []
    for name, bs, fields, blocks_np, lens_np in todo:
        if "zero-flag" not in name:
            continue
        knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs, **fields))
        blocks, lens = torch.from_numpy(blocks_np).to(dev), torch.from_numpy(lens_np).to(dev)
        hopper_match._on_card(blocks, lens, knobs)  # checks the knobs, fills in rungs and strides
        outs = hopper_match._outputs(blocks, knobs)
        recs = torch.zeros((REPS + 1, profiling.RECORD_WORDS), dtype=torch.int64, device=dev)
        slots = iter(range(REPS + 1))
        ms = common.event_seconds(
            lambda: hopper_match._launch(blocks, lens, outs, knobs, recs[next(slots)].data_ptr()), REPS) * 1e3
        cycles = recs[1:, 4:4 + len(profiling.COUNTERS["match"])].sum(0).tolist()
        phases = dict(zip(profiling.COUNTERS["match"], cycles))
        share = {k: phases[k] / phases["total"] for k in profiling.MATCH_PHASES}
        rec = {"case": name, "traced_ms": ms, "share": share, "sort_ms": ms * share["sort"]}
        if phases["lookups"]:  # stride-1 rungs with no window above 32768 split
            positions = REPS * len(blocks_np) * knobs["strides"].count(1) * (bs - hopper_match.HALF)
            rec.update(lookup_ms=ms * phases["lookup"] / (32 * phases["total"]),
                       lookups_per_position=phases["lookups"] / positions,
                       hit_share=phases["hits"] / phases["lookups"])
        out.append(rec)
    return out


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    todo = cases()
    common.warm(dev)
    records, _ = time_cases(dev, todo)
    traced = traced_phases(dev, todo)
    return [{"card": common.card(dev), "kernel_source": hopper_match.__file__}] + records + traced


def in_turns(parent: str, device: str) -> list[dict]:
    """This script and DIR's, each in a process of its own with its own
    checkout first on ``PYTHONPATH``: parent, this, this, parent. Each
    parent case says whether its length and lag sums equal this build's."""
    here, parent = pathlib.Path(__file__).resolve().parents[2], pathlib.Path(parent).resolve()
    out = []
    for name, root in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, str(root / "pim_compression_tpu_torch" / "scripts" / "match_time.py"), "--device", device],
            env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True, text=True, check=True)
        out.append({"build": name, "records": json.loads(proc.stdout.splitlines()[-1])})
    sums = [(r["len_sum"], r["lag_sum"]) for r in out[1]["records"] if "len_sum" in r]
    for turn in out:
        if turn["build"] == "parent":
            timed = [r for r in turn["records"] if "len_sum" in r]
            for r, want in zip(timed, sums):
                r["equal"] = (r["len_sum"], r["lag_sum"]) == want
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pim_compression_tpu_torch.scripts.match_time",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0", help="the CUDA device to measure (default cuda:0)")
    parser.add_argument("--parent", help="another checkout whose match kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    if args.parent:
        turns = in_turns(args.parent, args.device)
        common.OUT_DIR.mkdir(parents=True, exist_ok=True)
        (common.OUT_DIR / "match_time_turns.json").write_text(json.dumps(turns, indent=2) + "\n")
        print(json.dumps(turns))
        return 0
    rc = common.main("match_time", run, __doc__.splitlines()[0], ["--device", args.device])
    print(json.dumps(json.loads((common.OUT_DIR / "match_time.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
