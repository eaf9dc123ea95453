"""The ratio of a matcher config over files, from the match and emit functions alone.

    python -m pim_compression_tpu_torch.scripts.spec_ratio --bs 32768 --file xml --corpus DIR \\
        --config "rungs=4,16 rung_pick=1 ext_cap=48 neighbor=1 max_lag=8192" [--engine cuda|torch] [--device D]

The counterpart of the JAX package's ``scripts/spec_ratio.py``: the same
flags, the same ``--config "k=v ..."`` (the keyword arguments of the
reference's ``match_search_sorted``, with its defaults for the keys left
out; ``matcher=sweep`` with ``window``, ``coarse_window`` and ``granular``
runs the sweep matcher), and the same total: the stream header's two
varints, each block's emitted size and its 4-byte frame size, with no
triage, so the numbers match the CLI's. Each file is cut into blocks of
``--bs`` and run through the port's matcher (``hopper_match.match_blocks``
or ``hopper_sweep.sweep_match``) and the emit's sizes (``emit_blocks``), in
batches of 1024 blocks: the kernels on the card with the ``cuda`` engine
(the default), the plain versions with ``torch`` (on the CPU unless
``--device`` names another). Files come only from ``--corpus DIR``
(``<name>.txt``, or ``<name>.snappy`` decoded); without one, the tool
measures ``seeded``: the seeded text the port's tools use in its place.
Prints one line per file and config, as the JAX script does.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from pim_compression_tpu_torch.format.varint import encode_varint32
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.parallel import resolve_device
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import tooling, work_ledger

BATCH = 1024


def parse_config(s: str) -> dict:
    """``k=v`` pairs: the JAX script's parse (tuples for the rung lists,
    booleans for ``neighbor`` and ``sel_all``, integers otherwise), and
    ``matcher`` as a word."""
    cfg: dict = {}
    for part in s.split():
        k, v = part.split("=")
        if k in ("rungs", "rung_windows", "rung_strides"):
            cfg[k] = tuple(int(x) for x in v.split(","))
        elif k in ("neighbor", "sel_all"):
            cfg[k] = bool(int(v))
        elif k == "matcher":
            cfg[k] = v
        else:
            cfg[k] = int(v)
    return cfg


def measure(plain: bytes, bs: int, cfg: dict, engine: str = "cuda", device=None) -> tuple[int, float]:
    """(stream bytes, seconds) of ``plain`` at block size ``bs`` with the
    matcher config ``cfg`` (``parse_config``'s): the header's varints, the
    emitted sizes and 4 bytes a block. ``engine`` ``cuda`` runs the
    kernels (on a CUDA device; the CPU only through the plain versions),
    ``torch`` the plain versions, on ``device``."""
    dev = resolve_device(engine, device)
    knobs = work_ledger.reference_knobs(dict(cfg, block_size=bs))
    sweep = knobs.pop("matcher") == "sweep"
    if engine == "cuda":
        match = hopper_sweep.sweep_match if sweep else hopper_match.match_blocks
        emit = hopper_encode.emit_blocks
    else:
        match = hopper_sweep.sweep_match_torch if sweep else hopper_match.match_blocks_torch
        emit = hopper_encode.emit_blocks_torch
    blocks, lens = pipeline.blockize_plain(plain, bs)
    cap = pipeline.padded_capacity(bs)
    t0 = time.perf_counter()
    sizes = 0
    for i in range(0, len(lens), BATCH):
        b, n = (torch.from_numpy(a[i : i + BATCH]).to(dev) for a in (blocks, lens))
        mlen, mlag = match(b, n, **knobs)
        sizes += int(emit(b, n, mlen, mlag, cap)[1].long().sum())
    secs = time.perf_counter() - t0
    return len(encode_varint32(len(plain))) + len(encode_varint32(bs)) + sizes + 4 * len(lens), secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pim_compression_tpu_torch.scripts.spec_ratio",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--bs", type=int, default=32768)
    ap.add_argument("--file", action="append", default=None, help="a corpus file's name (repeatable; default xml)")
    ap.add_argument("--config", action="append", required=True, help='"k=v ..." (repeatable)')
    ap.add_argument("--engine", choices=["cuda", "torch"], default="cuda")
    ap.add_argument("--device", default=None, help="default cuda:0 for cuda, the CPU for torch")
    tooling.add_corpus_arg(ap)
    args = ap.parse_args(argv)
    if args.corpus:
        files = tooling.corpus_files(args.corpus, args.file or ["xml"])
    else:
        files = [("seeded", tooling.seed_text())]
    for name, plain in files:
        for cs in args.config:
            total, dt = measure(plain, args.bs, parse_config(cs), args.engine, args.device)
            ratio = 1 - total / len(plain)
            print(f"{name:10s} bs={args.bs} [{cs}] -> {total} bytes, ratio {ratio:.4f} ({dt:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
