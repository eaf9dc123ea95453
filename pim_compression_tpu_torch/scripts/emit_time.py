"""Time the emit kernel at the main paths' three shapes.

    python3 -m pim_compression_tpu_torch.scripts.emit_time [--device cuda:0]

Runs ``csrc/emit.cu`` through ``ops.hopper_encode.emit_blocks`` on
device-resident 1024-block batches of the seeded payloads ``chip_smoke.py``
makes, each on its matcher's output as the main path gives it: bs 32768 in
the zero-flag config (rung pick), bs 65536 in the zero-flag config as the
runtime runs it there (the ``sel_all`` ladder), and bs 8192 with the sweep
(window 2048, coarse 8192 granular), as ``chip_smoke.py`` phases 6, 9 and
11 do; then three fixed parses at 32 KB (``PATTERNS``: copies only, copies
and one-byte literal runs in turn, one long literal run), which split the
walk's cost by element. Each time is the mean device time of 10 back-to-back launches by
CUDA events. Each record carries the sum of the sizes and of the output
bytes, which two versions of the kernel must share, each block's parse
elements (copies and literal runs), counted on the card, and the cycles per
element of the block with the most, at the 1.98 GHz boost clock. Writes ``build/probes/emit_time.json`` and prints one
JSON line.

It runs as a file too, with another checkout's package first on
``PYTHONPATH`` (``PYTHONPATH=old python3 path/to/emit_time.py``), so that
two versions of the kernel are timed in one run on one card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pim_compression_tpu_torch import TorchCodecConfig
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import common
from pim_compression_tpu_torch.utils import streams

SEED = 20261016
BLOCKS = 1100  # the payloads' length in blocks, less 1000 bytes
BATCH = 1024
REPS = 10
BOOST_HZ = 1.98e9
SWEEP_MAIN = dict(matcher="sweep", match_window=2048, coarse_window=8192, coarse_mode="granular")


# Fixed parses at 32 KB, which split a walk's cost by element: length 4
# (a 2-byte copy at lag 100) at every position, so 8192 copies; at every
# fifth, so 6554 copies and 6553 one-byte literal runs; at none, so one
# literal run of 32768 bytes.
PATTERNS = {"copies": 1, "copy-literal": 5, "literal": 0}


def cases() -> list[tuple]:
    """(name, bs, config fields, blocks, (mlen, mlag) or None for the
    matcher's) of each timed case, on the host."""
    payload = streams.text_payload(BLOCKS * 32768 - 1000, SEED)
    wide = streams.text_payload(BLOCKS * 65536 - 1000, SEED)
    out = []
    for name, bs, fields, src in (("32768 zero-flag", 32768, {}, payload), ("65536 zero-flag", 65536, {}, wide),
                                  ("8192 sweep", 8192, SWEEP_MAIN, payload)):
        blocks = np.frombuffer(src[: BATCH * bs], np.uint8).reshape(BATCH, bs).copy()
        out.append((name, bs, fields, blocks, None))
    blocks = np.frombuffer(payload[: BATCH * 32768], np.uint8).reshape(BATCH, 32768)
    for name, every in PATTERNS.items():
        mlen = np.zeros_like(blocks)
        if every:
            mlen[:, ::every] = 4
        out.append((f"32768 pattern {name}", 32768, {}, blocks, (mlen, np.full(blocks.shape, 100, np.int16))))
    return out


def element_counts(mlen: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Copies + literal runs of each block's greedy parse (lazy-1 included),
    one lockstep step per position over the batch."""
    length = mlen.long()
    nxt = torch.zeros_like(length)
    nxt[:, :-1] = length[:, 1:]
    deferred = torch.where(nxt > length, 0, length).t().contiguous()
    nb, bs = mlen.shape
    lens = lens.long()
    next_accept = torch.zeros(nb, dtype=torch.int64, device=mlen.device)
    in_run = torch.zeros(nb, dtype=torch.bool, device=mlen.device)
    count = torch.zeros(nb, dtype=torch.int64, device=mlen.device)
    for p in range(bs):
        acc = (next_accept == p) & (lens > p)
        copy = acc & (deferred[p] >= 4)
        count += copy | (acc & ~copy & ~in_run)
        in_run = torch.where(acc, ~copy, in_run)
        next_accept = torch.where(acc, p + torch.where(copy, deferred[p], 1), next_accept)
    return count


def inputs(dev, todo) -> list[tuple]:
    """(name, blocks, lens, mlen, mlag, cap) on the card: each case's batch
    and its matcher's output."""
    out = []
    for name, bs, fields, blocks_np, matches in todo:
        blocks = torch.from_numpy(blocks_np).to(dev)
        lens = torch.full((len(blocks_np),), bs, dtype=torch.int32, device=dev)
        if matches is None:
            knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs, **fields))
            match = hopper_sweep.sweep_match if knobs.pop("matcher", "sorted") == "sweep" else hopper_match.match_blocks
            mlen, mlag = match(blocks, lens, **knobs)
        else:
            mlen, mlag = (torch.from_numpy(a).to(dev) for a in matches)
        out.append((name, blocks, lens, mlen, mlag, pipeline.padded_capacity(bs)))
    return out


def time_cases(cases, check=None, elements: bool = False) -> tuple[list[dict], list]:
    """Mean device ms of REPS launches of emit_blocks on each case, and each
    case's (comp, sizes); with ``check`` (such outputs of another build)
    each record says whether its output equals the other's; with
    ``elements`` it gives the parse's elements and cycles per element."""
    records, outputs = [], []
    for k, (name, blocks, lens, mlen, mlag, cap) in enumerate(cases):
        comp, sizes = hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap)
        # The timed launches' outputs are dropped, so the allocator hands each
        # the memory of the one before, with no allocation inside the timing.
        ms = common.event_seconds(lambda: hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap), REPS)
        rec = {"case": name, "bs": blocks.shape[1], "blocks": len(blocks), "cap": cap, "ms": ms * 1e3,
               "size_sum": int(sizes.long().sum()), "byte_sum": int(comp.long().sum())}
        if check is not None:
            rec["equal"] = bool(torch.equal(sizes, check[k][1]) and torch.equal(comp, check[k][0]))
        if elements:
            count = element_counts(mlen, lens)
            rec.update(elements_max=int(count.max()), elements_mean=float(count.double().mean()),
                       cycles_per_element=ms * BOOST_HZ / max(1, int(count.max())))
        records.append(rec)
        outputs.append((comp, sizes))
    return records, outputs


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    todo = inputs(dev, cases())
    common.warm(dev)
    records, _ = time_cases(todo, elements=True)
    return [{"card": common.card(dev), "kernel_source": hopper_encode.__file__}] + records


def main(argv=None) -> int:
    rc = common.main("emit_time", run, __doc__.splitlines()[0], argv)
    print(json.dumps(json.loads((common.OUT_DIR / "emit_time.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
