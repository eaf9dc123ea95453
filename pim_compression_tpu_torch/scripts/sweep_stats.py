"""A census of the data-dependent loop trips that set the matchers' cost.

    python -m pim_compression_tpu_torch.scripts.sweep_stats [--device cuda:0] [--blocks N] [--corpus DIR]

The counterpart of the JAX package's ``scripts/sweep_stats.py``, which
counted the sorted matcher's chunk-distance sweep iterations, the loop that
set the TPU kernels' cost. The port's kernels have other loops, so the
census counts theirs, on ``--blocks`` blocks (16) of ``chip_smoke.py``'s
seeded text (or of the ``--corpus`` texts):

- the sweep (``csrc/sweep.cu``), from ``utils/sweep_table.py``'s mirror of
  its table walk, over ``SWEEP_GRID`` (``match_window``, ``coarse_window``,
  ``coarse_mode``) at bs 8192 and 16384: the entries each walking
  position reads (its lane steps and 32 a warp round: mean, p99, max), the
  share of them that outrun a lane's budget (``kBudget``, 8 entries) and go
  to their warp, the warps' steps, and the (position, lag) pairs whose first
  words match (``hopper_sweep.sweep_pairs``, the work ledger's count);
- the sorted matcher (``csrc/match.cu``) in the zero-flag config at 32 KB
  (the rung pick over rungs 4 and 16, the JAX census's flagship), over
  ``max_lag`` in {0, 8192} (the JAX census's axis) and ``ext_cap`` in {48,
  64}: each rung's candidate share, and the trips of the winner's 4-byte
  extension loop (``extend`` in ``match.cu``: one 4-byte compare a trip,
  up to the first unequal word or the cap) per position (mean, p99, max),
  split by the rung whose candidate won. The JAX census's ``sweep_span``
  axis has no counterpart: the port's match kernel has no chunk sweeps.

The mirror runs on the host; the matchers' plain versions and the pair
count run on ``--device`` (the card by default, the CPU with ``--device
cpu``). Writes ``build/tooling/sweep_stats.json`` and prints one line per
point.
"""

from __future__ import annotations

import argparse
import collections
import json

import numpy as np
import torch

from pim_compression_tpu_torch.ops import hopper_match, hopper_sweep
from pim_compression_tpu_torch.scripts import tooling, work_ledger
from pim_compression_tpu_torch.utils import sweep_table

BLOCKS = 16
SWEEP_SIZES = (8192, 16384)
# (match_window, coarse_window, coarse_mode); a coarse window at or below
# the window means no coarse search.
SWEEP_GRID = [(512, 0, "sampled"), (2048, 0, "sampled")] + [
    (w, c, mode) for w in (512, 2048) for c in (4096, 8192, 16384) for mode in ("sampled", "granular")
]
SORTED_BS = 32768
SORTED_RUNGS = (4, 16)
MAX_LAGS = (0, 8192)
EXT_CAPS = (48, 64)


def _spread(x: np.ndarray) -> dict:
    x = np.asarray(x, np.float64)
    return {"mean": float(x.mean()), "p99": float(np.percentile(x, 99)), "max": float(x.max())} if x.size else {}


def sweep_point(blocks: np.ndarray, lens: np.ndarray, knobs: dict, device) -> dict:
    """The mirror's walk and the first-word pairs of one sweep config."""
    stats, walked = collections.Counter(), []
    mlen, mlag = sweep_table.sweep_table(blocks, lens, knobs["window"], knobs["coarse_window"], knobs["granular"],
                                         stats=stats, walked=walked)
    walked = np.concatenate(walked)
    args = [torch.from_numpy(a).to(device) for a in (blocks, lens, mlen, mlag)]
    visited, first_word = hopper_sweep.sweep_pairs(*args, **knobs)
    positions = stats["positions"]
    return {
        "positions": positions, "walks": stats["walks"], "entries_walked": int(walked.sum()),
        "entries_per_walk": _spread(walked), "handed_off_share": stats["handed_off"] / max(1, stats["walks"]),
        "warp_steps_mean": stats["warp_steps"] / max(1, stats["warps"]), "warp_steps_max": stats["max_warp_steps"],
        "collisions_per_position": stats["collisions"] / positions,
        "first_word_pairs": first_word, "first_word_pairs_per_position": first_word / positions,
        "visited_pairs_per_position": visited / positions,
    }


def extend_trips(w4: torch.Tensor, lens: torch.Tensor, cand: torch.Tensor, cap: int) -> torch.Tensor:
    """Trips of ``match.cu``'s ``extend`` loop at every position for the
    candidate lags ``cand`` (0 = none): 4-byte compares up to the first
    unequal word or ``min(cap, len - p)`` bytes."""
    nb, bs = w4.shape
    rows = torch.arange(bs, device=w4.device).expand(nb, bs)
    limit = torch.clamp(torch.clamp(lens[:, None].long() - rows, max=cap), min=0)
    has = (cand > 0) & (limit > 0)
    src = (rows - cand).clamp(0, bs - 1)
    words = torch.zeros_like(cand)
    still = has.clone()
    for k in range(cap // 4):
        a = hopper_match._shift_up(w4, 4 * k) if k else w4
        b = torch.gather(w4, 1, (src + 4 * k).clamp(max=bs - 1))
        still &= a == b
        words += still
    return torch.where(has, torch.minimum(words + 1, (limit + 3) // 4), 0)


def sorted_point(blocks: torch.Tensor, lens: torch.Tensor, max_lag: int, ext_cap: int) -> dict:
    """The rung pick's candidates and its winner's extension trips."""
    nb, bs = blocks.shape
    rows = torch.arange(bs, device=blocks.device)
    data = torch.where(rows[None, :] < lens[:, None], blocks, 0).long()
    w4 = hopper_match._word4(data)
    sel = torch.zeros_like(w4)
    won = torch.zeros_like(w4)
    h, span, shares = w4, 4, {}
    for rung in SORTED_RUNGS:
        while span < rung:  # the hash ladder, as match_blocks_torch steps it
            h = hopper_match._mul32(h, hopper_match.HASH_M1) ^ hopper_match._mul32(
                hopper_match._shift_up(h, span), hopper_match.HASH_M2)
            span *= 2
        cand = hopper_match._prev_lags(h, 1)[0]
        if max_lag:
            cand = torch.where(cand <= max_lag, cand, 0)
        shares[rung] = float((cand > 0).double().mean())
        sel = torch.where(cand > 0, cand, sel)
        won = torch.where(cand > 0, rung, won)
    trips = extend_trips(w4, lens, sel, ext_cap)
    positions = nb * bs
    return {
        "positions": positions, "candidate_share": shares,
        "trips_per_position": _spread(trips.flatten().cpu().numpy()),
        "by_winning_rung": {rung: {"share": float((won == rung).double().mean()),
                                   "trips_per_position": int(trips[won == rung].sum()) / positions}
                            for rung in SORTED_RUNGS},
    }


def run(device="cuda:0", blocks: int = BLOCKS, corpus=None, grid=SWEEP_GRID, sweep_sizes=SWEEP_SIZES,
        max_lags=MAX_LAGS, ext_caps=EXT_CAPS) -> dict:
    """The census: a record per sweep point and per sorted-matcher point."""
    dev = work_ledger.resolve(device)
    cache: dict = {}
    out = {"device": str(dev), "blocks": blocks, "budget": sweep_table.BUDGET, "sweep": [], "sorted": []}
    for bs in sweep_sizes:
        b, n = work_ledger.batch(work_ledger.payload_for(bs, corpus, cache), bs, blocks)
        seen = []
        for window, coarse, mode in grid:
            knobs = hopper_sweep.sweep_knobs(bs, window, coarse, mode == "granular")
            if knobs in seen:  # a coarse window past the block is the block's
                continue
            seen.append(knobs)
            rec = {"bs": bs, "match_window": window, "coarse_window": coarse, "coarse_mode": mode, "knobs": knobs}
            out["sweep"].append({**rec, **sweep_point(b, n, knobs, dev)})
    b, n = work_ledger.batch(work_ledger.payload_for(SORTED_BS, corpus, cache), SORTED_BS, blocks)
    b, n = torch.from_numpy(b).to(dev), torch.from_numpy(n).to(dev)
    for max_lag in max_lags:
        for ext_cap in ext_caps:
            rec = {"bs": SORTED_BS, "rungs": list(SORTED_RUNGS), "max_lag": max_lag, "ext_cap": ext_cap}
            out["sorted"].append({**rec, **sorted_point(b, n, max_lag, ext_cap)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pim_compression_tpu_torch.scripts.sweep_stats",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0", help="where the plain versions run (default cuda:0)")
    ap.add_argument("--blocks", type=int, default=BLOCKS, help=f"blocks per batch (default {BLOCKS})")
    tooling.add_corpus_arg(ap)
    ap.add_argument("--out", default="build/tooling/sweep_stats.json")
    args = ap.parse_args(argv)
    census = run(args.device, args.blocks, args.corpus)
    for r in census["sweep"]:
        e = r["entries_per_walk"]
        print(f"sweep bs={r['bs']} w={r['match_window']} c={r['coarse_window']} {r['coarse_mode']}: entries a walk "
              f"{e['mean']:.2f} (p99 {e['p99']:.0f}, max {e['max']:.0f}), handed off {r['handed_off_share']:.4f}, "
              f"first-word pairs {r['first_word_pairs_per_position']:.2f} a position")
    for r in census["sorted"]:
        t = r["trips_per_position"]
        print(f"sorted bs={r['bs']} max_lag={r['max_lag']} ext_cap={r['ext_cap']}: extension trips a position "
              f"{t['mean']:.3f} (p99 {t['p99']:.0f}, max {t['max']:.0f}); candidates {r['candidate_share']}")
    path = tooling.output_path(args.out)
    path.write_text(json.dumps(census, indent=2) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
