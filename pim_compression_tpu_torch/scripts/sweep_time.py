"""Time the sweep kernel on chip_smoke's sweep batches and on hard blocks.

    python3 -m pim_compression_tpu_torch.scripts.sweep_time [--device cuda:0] [--parent DIR]
    python3 -m pim_compression_tpu_torch.scripts.sweep_time --steps

Runs ``csrc/sweep.cu`` through ``ops.hopper_sweep.sweep_match`` on
device-resident batches: the 1024-block batch of ``chip_smoke.py``'s 8 KB
sweep payload in the main config (window 2048, coarse 8192, granular) and
sampled, and at window 512 / coarse 4096; phase 11's 128 payload blocks at
16384 (window 512, coarse 16384, granular); and 1024 copies of each of
``streams.sweep_hard_blocks(8192, 2048)``'s blocks in the main config: all
zeros (every walk ends at its first entry: a batch of byte runs), key
collisions at every 4-aligned position, two letters (long chains, no early
exit), a word at every 8-aligned position. Each time is the mean device
time of 10 back-to-back launches by CUDA events. Each record carries a
digest of the lengths and lags, which two versions of the kernel must
share, the bound (``work_ledger.sweep_work``: the larger of the bytes the
function moves over 3.35 TB/s and one operation per position plus one per
pair whose first words match over the int32 issue rate) and its share of
the time, and the build's
ptxas line (registers, spills) and CTAs per SM.

``--parent DIR`` also builds ``DIR/pim_compression_tpu_torch/csrc/sweep.cu``
(another checkout, e.g. the parent commit unpacked with ``git archive``)
with the same flags and times both kernels in turns on the same tensors,
parent, this, this, parent; each record of the parent says whether its
output equals this kernel's. ``--steps`` needs no card: it runs the NumPy
mirror of the walk (``utils/sweep_table.py``) on the first 32 blocks of
each case and reports the walk's steps per position and per warp (its
lanes' longest walk plus its rounds). Writes ``build/probes/sweep_time.json``
(or ``sweep_steps.json``) and prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import pathlib

import numpy as np

from pim_compression_tpu_torch.scripts import common, work_ledger
from pim_compression_tpu_torch.utils import streams

SEED = 20261016
BLOCKS = 1100  # chip_smoke.py's payload: 1100 blocks of 32 KB, less 1000 bytes
BATCH = 1024
REPS = 10
STEP_BLOCKS = 32  # blocks of each case the mirror walks for --steps
MAIN = dict(window=2048, coarse_window=8192, granular=True)
# Rows of streams.sweep_hard_blocks timed as whole batches.
HARD = (("zeros", 1), ("collisions", 4), ("two letters", 3), ("word at every 8th", 2))


def cases() -> list[tuple]:
    """(name, knobs, blocks, lens) of each timed case, on the host."""
    payload = streams.text_payload(BLOCKS * 32768 - 1000, SEED)
    main = np.frombuffer(payload[: BATCH * 8192], np.uint8).reshape(BATCH, 8192).copy()
    full = np.full(BATCH, 8192, np.int32)
    big = np.frombuffer(payload[: 128 * 16384], np.uint8).reshape(128, 16384).copy()
    out = [
        ("8192 granular w2048 c8192", MAIN, main, full),
        ("8192 sampled w2048 c8192", dict(MAIN, granular=False), main, full),
        ("8192 granular w512 c4096", dict(window=512, coarse_window=4096, granular=True), main, full),
        ("16384 granular w512 c16384", dict(window=512, coarse_window=16384, granular=True), big,
         np.full(128, 16384, np.int32)),
    ]
    hard, hard_lens = streams.sweep_hard_blocks(8192, MAIN["window"], SEED)
    for name, row in HARD:
        out.append((f"8192 granular w2048 c8192, {name}", MAIN, np.repeat(hard[row : row + 1], BATCH, axis=0),
                    np.full(BATCH, hard_lens[row], np.int32)))
    return out


def ctas_per_sm(handle, bs: int, dev) -> int | None:
    """The build's CTAs per SM at bs, where it answers the query."""
    if not hasattr(handle, "pim_sweep_ctas_per_sm"):
        return None
    handle.pim_sweep_ctas_per_sm.restype = ctypes.c_int
    handle.pim_sweep_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    return handle.pim_sweep_ctas_per_sm(bs, dev.index)


def time_cases(todo, check=None) -> tuple[list[dict], list]:
    """Mean device ms of REPS launches of sweep_match on each case (name,
    knobs, blocks, lens on the card, work), its digest and share of the
    bound; with ``check`` (another build's outputs) whether they are equal."""
    import torch

    from pim_compression_tpu_torch.ops import hopper_sweep

    records, outputs = [], []
    for k, (name, knobs, blocks, lens, work) in enumerate(todo):
        mlen, mlag = hopper_sweep.sweep_match(blocks, lens, **knobs)
        digest = hashlib.sha256(mlen.cpu().numpy().tobytes() + mlag.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = common.event_seconds(lambda: hopper_sweep.sweep_match(blocks, lens, **knobs), REPS) * 1e3
        rec = {"case": name, "blocks": int(blocks.shape[0]), "ms": ms, "digest": digest, **work,
               "share": work["bound_ms"] / ms}
        if check is not None:
            rec["equal"] = bool(torch.equal(mlen, check[k][0]) and torch.equal(mlag, check[k][1]))
        records.append(rec)
        outputs.append((mlen, mlag))
    return records, outputs


def inputs(dev, todo) -> list[tuple]:
    """Each case on the card, with the bound of its work (from the plain
    version's lengths and lags, which every build must give)."""
    import torch

    from pim_compression_tpu_torch.ops import hopper_sweep

    out = []
    for name, knobs, blocks_np, lens_np in todo:
        blocks, lens = torch.from_numpy(blocks_np).to(dev), torch.from_numpy(lens_np).to(dev)
        bs = blocks.shape[1]
        mlen, mlag = hopper_sweep.sweep_match(blocks, lens, **knobs)
        count = work_ledger.sweep_work(blocks, lens, mlen, mlag, knobs)
        work = {"bs": bs, "knobs": knobs, "bound_ms": count["bound_ms"], "bound_by": count["bound_by"],
                "visited_pairs": count["visited_pairs"], "first_word_pairs": count["first_word_pairs"]}
        out.append((name, knobs, blocks, lens, work))
    return out


def run(device, parent: str | None = None) -> list[dict]:
    import torch

    from pim_compression_tpu_torch.ops import _build
    from pim_compression_tpu_torch.scripts.match_variants import build_variants

    dev = common.cuda_device(device)
    torch.cuda.set_device(dev)
    default = _build.load()
    builds = build_variants({"this": {}}, "sweep.cu")
    if parent:
        csrc = pathlib.Path(parent) / "pim_compression_tpu_torch" / "csrc"
        builds.update(build_variants({"parent": {}}, "sweep.cu", csrc))
    todo = inputs(dev, cases())
    common.warm(dev)
    head = {"card": common.card(dev), "builds": {}}
    for name, (handle, ptxas) in builds.items():
        ctas = {bs: ctas_per_sm(handle, bs, dev) for bs in (8192, 16384)}
        head["builds"][name] = {"ptxas": ptxas, "ctas_per_sm": ctas}
    out, want = [head], None
    order = ["parent", "this", "this", "parent"] if parent else ["this"]
    try:
        for name in order:
            _build._lib = builds[name][0]  # hopper_sweep.sweep_match launches through _build.load()
            records, outputs = time_cases(todo, check=want if name == "parent" else None)
            if name == "this":
                want = want or outputs
            out.append({"build": name, "cases": records})
    finally:
        _build._lib = default
    if parent:  # the parent's first run had no outputs of this build to hold its own against
        for rec, ref in zip(out[1]["cases"], out[2]["cases"]):
            rec["equal"] = rec["digest"] == ref["digest"]
    return out


def steps() -> list[dict]:
    """The mirror's walk on the first STEP_BLOCKS blocks of each case."""
    from pim_compression_tpu_torch.utils import sweep_table

    out = [{"budget": sweep_table.BUDGET, "threads": sweep_table.THREADS, "blocks_per_case": STEP_BLOCKS}]
    for name, knobs, blocks, lens in cases():
        stats = collections.Counter()
        sweep_table.sweep_table(blocks[:STEP_BLOCKS], lens[:STEP_BLOCKS], knobs["window"], knobs["coarse_window"],
                                knobs["granular"], stats=stats)
        out.append({"case": name, "steps_per_position": stats["lane_steps"] / stats["positions"],
                    "rounds_per_position": stats["rounds"] / stats["positions"],
                    "handed_off_share": stats["handed_off"] / stats["positions"],
                    "warp_steps_mean": stats["warp_steps"] / stats["warps"], "warp_steps_max": stats["max_warp_steps"],
                    "collisions_per_position": stats["collisions"] / stats["positions"]})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pim_compression_tpu_torch.scripts.sweep_time",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda:0", help="the CUDA device to measure (default cuda:0)")
    parser.add_argument("--parent", help="another checkout whose sweep kernel is timed in turns with this one")
    parser.add_argument("--steps", action="store_true", help="report the mirror's steps; needs no card")
    args = parser.parse_args(argv)
    name = "sweep_steps" if args.steps else "sweep_time"
    records = steps() if args.steps else run(args.device, args.parent)
    common.OUT_DIR.mkdir(parents=True, exist_ok=True)
    (common.OUT_DIR / f"{name}.json").write_text(json.dumps(records, indent=2) + "\n")
    print(json.dumps(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
