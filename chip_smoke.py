#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's decompress and compress main paths on one GPU,
at 32 KB and at 64 KB blocks, through the runtime and through the CLI.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: a CUDA device must be present; prints the card and its power limit;
  2. build: compiles the kernels in pim_compression_tpu_torch/csrc with nvcc,
     and logs the decode kernel's walks per SM (its occupancy query) at bs
     32768 and 65536;
  3. kernel vs plain: the Hopper decode kernel and the plain PyTorch decode
     on the same CUDA tensors (hand-built blocks, a 128-block batch at 32 KB,
     blocks at 4 KB and 24 KB, malformed mutants; at 64 KB 128 blocks of the
     payload with a block whose copies reach past 32768, hand-built blocks and
     mutants in one batch, and blocks at 40 KB; blocks and mutants at 100,
     1000 and 4097, sizes that are not multiples of 16): equal verdicts on
     every block, equal bytes on every valid block (exact: the codec is
     integer-only);
  4. main path: a ~36 MB text-like payload (1100 blocks of 32 KB: a full
     1024-block batch, a tail batch, a partial last block) compressed by the
     native host codec and decompressed through runtime.decompress on the
     "cuda" engine; the output must equal the payload and the kernel's launch
     count must show that every batch went through it. Prints end-to-end,
     kernel-only, plain-PyTorch and single-threaded host GB/s;
  5. error path: a corrupt block raises under validate, and an out-of-range
     declared block size is rejected;
  6. encode kernels vs plain: the Hopper match and emit kernels and their
     plain PyTorch versions on the same CUDA tensors (128 blocks and a full
     1024-block batch of the payload at 32 KB, 2 MB of it at 4 KB and 24 KB,
     hand-built edge blocks): every match length and lag, every size and
     every output byte equal (exact);
  7. compress main path: the phase-4 payload with 8 random blocks spliced in
     compressed through runtime.compress on the "cuda" engine; the stream
     must equal the "torch" engine's on the GPU, decode back through the
     "cuda" engine and the native host codec, divert the 8 random blocks,
     pass verify=True, and both kernels' launch counts must equal the batch
     count. Prints end-to-end, kernel-only, plain-PyTorch and single-threaded
     host GB/s and the stream ratio beside the native codec's;
  8. encode error path: under strict_engine the sweep matcher above 16384
     and a block size that is not a multiple of 128, and granular at a block
     size that is not a multiple of 256 and a sort window that does not
     divide the padded sort size in any case, are refused with BAD_ARGUMENT,
     and no kernel is launched;
  9. 64 KB kernels vs plain: the match and emit kernels on 128 blocks of the
     64 KB payload at the zero-flag config (switched to the sel_all ladder)
     and at each preset's 64 KB row: every length, lag, size and byte equal;
 10. 64 KB main paths: a ~72 MB payload (1100 blocks of 64 KB) with random
     blocks spliced in compressed through runtime.compress on the "cuda"
     engine (equal to the "torch" engine's stream on the GPU, verify=True,
     decodes back through the "cuda" engine and native; launch counts equal
     the batch counts), and the native codec's 64 KB stream of the payload
     decompressed through the "cuda" engine. Prints end-to-end, kernel-only,
     plain-PyTorch and single-threaded host GB/s and the stream ratio;
 11. sweep kernel vs plain: the Hopper sweep kernel and its plain PyTorch
     version on the same CUDA tensors (128 blocks of the payload at bs 8192
     with match_window 2048 and coarse_window 8192, sampled and granular, and
     with 512/4096 granular; 128 blocks at bs 16384, 512/16384 granular; the
     sweep's hand-built edge blocks; the table walk's hard blocks with the
     edge blocks, the 512/4096 and the 16384 batches; a full 1024-block batch
     of the main config): every length and lag equal (exact);
 12. sweep main path: the phase-4 payload cut to 1100 blocks of 8 KB, with 8
     random blocks spliced in, compressed through runtime.compress on the
     "cuda" engine with the sweep (2048/8192, granular), checked as in phase 7
     (the sweep and emit kernels' launch counts equal the batch count, and the
     sorted matcher's stays 0; blocks of the payload's own random stretches
     may be diverted too, each holding over 7.5 bits of entropy a byte);
 13. sort-mode kernels vs plain: the match and emit kernels on 128 blocks of
     the payload plus the hand-built blocks for each of the sorted matcher's
     sort-mode and ladder configs SORT_MODES ((a)-(d) at 32 KB, (e) at 64 KB):
     every length, lag, size and byte equal; (a) also on a full 1024-block
     batch, timed;
 14. the CLI at full width: `python -m pim_compression_tpu_torch -c -b 32768
     --json` on the phase-7 payload, with no matcher flags (its stream must
     equal phase 7's) and with config (a)'s flags (equal to the "torch"
     engine's stream on the GPU), and `-c -b 65536` with config (e)'s flags
     on the 64 KB payload (equal to runtime.compress's); each stream
     decompresses back through the CLI and the native codec, the JSON line
     names the cuda engine, and the kernels' launch counts, read in each CLI
     process after its run, equal its batch counts;
 15. the probes: each probe kernel of csrc/probes.cu (the gather and
     elementwise chains, the copy, the mix rounds and the chain fold) against
     its plain PyTorch version on the same CUDA tensors, exactly, at every
     shape of the JAX package's probe scripts of at most 50,000 steps (the
     1M- and 1.6M-step chains are timed only), the copy also in turns with
     its library call x[:rows] + 1 on the same cold inputs (COPY_ROUNDS
     rounds of 20 launches each); then, with the launch counts
     set to 0, the port's three probe scripts (transfer_probe, hw_probe,
     emu_calibrate) through their run(), which must launch every probe
     kernel; their records are printed;
 16. devbench: runtime.devbench.slope_measure on the "cuda" engine at bs
     32768 over the phase-4 payload: its G=8 batch is phase 6's main batch,
     so its encode ratio must equal round(1 - r, 4) with r phase 6's
     compressed / plaintext ratio; each kernel launches once per timed call;
 17. pipelined main paths: phase 4's stream and phase 7's payload at
     batch_blocks 128 (9 batches each way) at pipeline depths 1, 2 and 4:
     every stream must equal phase 7's and every output the payload, the
     launch counts the batch counts; verify=True passes at depth 4, and
     corrupt blocks raise at depth 4 naming the block depth 1 names. Prints
     best-of-3 GB/s and phases per depth, and, from timing events on the
     staging ring's slot streams, how long each batch's h2d copy and
     kernels ran before the batch ahead of it was back; at depth 2 and 4
     that must be above 0 for some batch in each direction;
 18. the portable engine (ops/{primitives,decode,encode}.py: plain PyTorch
     ops on the card, no hand kernel): phase 7's and phase 10's spliced
     payloads compressed through runtime.compress on the "portable" engine
     (raw blocks diverted; decodes back through native, the "cuda" engine
     and the portable decoder) and the phase-4 and phase-10 native streams
     decompressed, best of 3; one 1024-block batch's device time and peak
     memory for encode_blocks and decode_blocks; the first 64 blocks at 32
     KB and 16 at 64 KB encoded and decoded alike on the card and the CPU;
     256 block mutants at bs 1024 with out and err equal on the card and
     the CPU; the "cuda" engine's envelope fallback (the sweep at 32768,
     bs 128): the portable stream, a warning and an engine_fallback note,
     no kernel launched, and under strict_engine BAD_ARGUMENT before any
     launch. Its records make the "portable" JSON line.
 19. devices and processes: (a) phase 7's spliced payload and phase 4's
     stream through runtime.compress and decompress over 2 mesh entries
     (mesh_devices=2 on the first two cards, or two entries on cuda:0 where
     there is one card): the stream must equal phase 7's, the output the
     payload, each kernel's launches the shards (one per entry of each
     batch); best-of-3 GB/s beside phases 4 and 7; (b) two OS processes on
     a gloo group (scripts/multiproc_worker.py), each on its card by local
     rank: compress_to_file and decompress_to_file of phase 7's payload;
     the file must equal phase 7's stream, the round trip the payload, the
     block ranges be disjoint and cover the file, each rank launch every
     kernel, each rank's peak RSS stand below half of this script's own
     peak while it holds HELD_BYTES of touched pages; GB/s over the slowest
     rank's wall; (c) dryrun_multichip over 2
     and 8 mesh entries placed round-robin on the cards. Its records make
     the "devices" JSON line.
 20. the tooling (pim_compression_tpu_torch/scripts/ and parallel/dryrun.py):
     (a) the entry point (parallel/dryrun.py::entry), whose decode of its three blocks must equal the
     oracle's with every error bit 0, and `python -m
     pim_compression_tpu_torch.parallel.dryrun` in a fresh process; (b) the
     host-phase bench at 32 MB; (c) the multi-process bench over 1 and 2
     ranks on the cuda engine at phase 7's payload size: round trips exact,
     each rank's peak RSS below phase 19 (b)'s bar; (d) the benchmark
     runner on the native and cuda engines over mesh sizes 1 and 2 at the
     zero-flag config, 36 MB of seeded text: round trips exact, each cuda
     point's stream of its row's size and decoded by the oracle to the
     input; (e) the corpus check with no --corpus, which checks no file; (f) the output
     parser on phase 14's CLI stdout, which must give the JSON line's phases
     and ratio. Its records make the "tooling" JSON line; its launches (this
     process and the ranks) join the kernels line as "phase 20".
 21. the measurement tools (pim_compression_tpu_torch/scripts/), in at most
     MEASURE_BUDGET_S seconds: (a) the work ledger's port rows on the main
     batches, whose decode, match and emit bounds must equal phases 4, 6, 9
     and 10's (the kernels line's and phase 13's); (b) kernel_attrib on full
     batches (the decode at 32 KB, the zero-flag config at 32 KB, config (e)
     at 64 KB), whose parts and glue must add to the whole call within 5 %
     and whose outputs must equal the runtime's; (c) pipeline_times at 32 KB,
     both directions; (d) spec_ratio on 8 MB of the payload with the
     zero-flag config on the cuda engine, whose total must equal the torch
     engine's on the card and the runtime's stream without triage; (e)
     validate --quick on config (a). Its records make the "measure" JSON
     line; its launches join the kernels line as "phase 21".
Phases 4, 7, 10, 12 and 14 run at the default pipeline depth, 2. Phases 18
to 21 run after the launch counts of the other phases are read.
Before the kernels line, a "portable" JSON line gives phase 18's records,
a "devices" JSON line phase 19's, a "tooling" JSON line phase 20's, a
"measure" JSON line phase 21's, and a "probes" JSON line gives the card's measured
device copy rate and int32 rates beside the datasheet's (the bounds keep the
datasheet's). The line before the last is a JSON summary of the kernels, each with its
time, its plain version's, its launches on the main paths and its bound,
counted by pim_compression_tpu_torch/scripts/work_ledger.py (decode_work,
match_work, sweep_work, emit_work, probe_work: the larger of the bytes it
must move over the card's memory rate and the integer operations its inputs
need over the card's integer rate: for the sorted matcher one table step per
sorted row (ceil(bs / stride) of a rung) and candidate (prev_k on the 4-byte
rung in the ladder modes) plus one word compare per 4 bytes of each output
length; for the sweep one table step per position plus the pairs whose
first words match, with the exhaustive loop's pairs beside; for a probe the
steps its inputs take); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import subprocess
import sys
import tempfile
import time

BS = 32768
WIDE_BS = 65536
SWEEP_BS = 8192
ODD_SIZES = (100, 1000, 4097)  # decode block sizes outside the encoder's envelope (phase 3)
MAIN_BLOCKS = 1100
SEED = 20261016
RANDOM_BLOCKS = (3, 100, 333, 512, 777, 1023, 1024, 1090)  # spliced into the compress payloads
PIPE_BATCH = 128  # phase 17's batch: 9 batches each way at 32 KB
PIPE_DEPTHS = (1, 2, 4)
PIPE_CORRUPT = (300, 700)  # in the 3rd and the 6th of phase 17's batches
MEASURE_BUDGET_S = 90  # phase 21's
# A launcher's touched buffer while it runs ranks (phases 19 (b) and 20 (c)):
# it lifts this process's VmHWM, whose half is the bar for each rank's peak
# RSS, to well above any rank's own peak, and a rank that reported its
# launcher's peak would stand at twice the bar.
HELD_BYTES = 16 << 30
# The sweep's main config: README's best bs-8192 point (-b 8192 --matcher
# sweep --window 2048 --coarse-window 8192 --coarse-mode granular).
SWEEP_MAIN = dict(matcher="sweep", match_window=2048, coarse_window=8192, coarse_mode="granular")
# The sorted matcher's sort modes and ladders, as config fields with their
# CLI flags: (a) the capped per-rung ladder with half-density long rungs,
# (b) the uncapped ladder (the CLI's "ratio champion"), (c) the windowed rung
# pick, (d) sel_all with the 32-byte rung at 1/8 density (config.py's
# example), (e) at 64 KB (switched to sel_all) a stride-2 rung's 17-bit keys
# and the window.
SORT_MODES = {
    "a": (BS, dict(rungs=None, prev_k=4, sel_cap=16, stride2_min=16),
          ["--rungs", "full", "--prev-k", "4", "--sel-cap", "16", "--stride2-min", "16"]),
    "b": (BS, dict(rungs=(4, 16), rung_pick=False, prev_k=6), ["--no-rung-pick", "--prev-k", "6"]),
    "c": (BS, dict(rungs=(4, 16), sort_window=8192), ["--sort-window", "8192"]),
    "d": (BS, dict(rungs=(4, 32), prev_k=2, sel_cap=16, sel_all=True, rung_strides=(1, 8)),
          ["--rungs", "4,32", "--prev-k", "2", "--sel-cap", "16", "--sel-all", "--rung-strides", "1,8"]),
    "e": (WIDE_BS, dict(rungs=(4, 32), rung_strides=(1, 2), sort_window=16384),
          ["--rungs", "4,32", "--rung-strides", "1,2", "--sort-window", "16384"]),
}
# The probes' main shapes, where the kernels line times them (phase 15): the
# copy at its largest, the mix rounds at their longest, the chain fold at its
# largest point a plain version is compared at.
PROBE_COPY = (32768, 32768)
COPY_ROUNDS = 10  # rounds of the copy kernel and its library call in turns (phase 15)
PROBE_MIX_ITERS = 8000
PROBE_CHAIN = (8192, 50_000)
CHAIN_DOUBLE = (1.8, 2.2)  # the chains' time at twice the steps over their time, at least and at most
# Runs the CLI as `python -m pim_compression_tpu_torch` does, then prints
# the kernels' launch counts of that process as its last line.
CLI_RUN = (
    "import json, runpy, sys\n"
    "from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep\n"
    "sys.argv[0] = 'pim_compression_tpu_torch'\n"
    "try:\n"
    "    runpy.run_module('pim_compression_tpu_torch', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "print(json.dumps({'rc': rc, 'decode': hopper_decode.LAUNCHES, 'match': hopper_match.LAUNCHES,\n"
    "                  'sweep': hopper_sweep.LAUNCHES, 'emit': hopper_encode.LAUNCHES}))\n"
)

def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn, from CUDA events around reps calls."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def held_launcher_hwm(run):
    """``run()`` while this process holds ``HELD_BYTES`` of touched pages;
    returns (its result, this process's VmHWM in MB after it)."""
    import numpy as np

    from pim_compression_tpu_torch.scripts import multiproc_worker

    held = np.ones(HELD_BYTES, np.uint8)  # every page written
    try:
        return run(), multiproc_worker.peak_rss_mb()
    finally:
        del held


def check_rank_peaks(what: str, peaks: list, hwm: float) -> None:
    """Each rank's peak RSS below half of its launcher's VmHWM."""
    if any(not p < hwm / 2 for p in peaks):
        raise AssertionError(f"{what}: a rank's peak RSS {peaks} MB is not below half of chip_smoke.py's "
                             f"peak {hwm:.1f} MB, which holds {HELD_BYTES >> 20} MB")


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_probes, hopper_sweep

    hopper_decode.LAUNCHES = hopper_match.LAUNCHES = hopper_sweep.LAUNCHES = hopper_encode.LAUNCHES = 0
    hopper_probes.LAUNCHES.update(dict.fromkeys(hopper_probes.LAUNCHES, 0))


def to_device(blocks, block_size, device):
    """(payload, out_len) pairs -> comp/comp_len/out_len tensors on device."""
    import numpy as np
    import torch

    from pim_compression_tpu_torch.runtime import pipeline

    cap = pipeline.padded_capacity(block_size)
    comp = np.zeros((len(blocks), cap), np.uint8)
    clen = np.zeros(len(blocks), np.int32)
    olen = np.zeros(len(blocks), np.int32)
    for i, (payload, out_len) in enumerate(blocks):
        comp[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        clen[i], olen[i] = len(payload), out_len
    return tuple(torch.from_numpy(a).to(device) for a in (comp, clen, olen))


def stream_blocks(stream: bytes) -> list[tuple[bytes, int]]:
    from pim_compression_tpu_torch.runtime import pipeline

    info = pipeline.scan_frames(stream)
    return [
        (stream[o : o + s], int(n))
        for o, s, n in zip(info["payload_off"], info["payload_size"], info["out_size"])
    ]


def compare(name, args, block_size, expected=None, reps=5):
    """Kernel vs plain version on the same CUDA tensors; returns a stats dict."""
    import torch

    from pim_compression_tpu_torch.ops import hopper_decode
    from pim_compression_tpu_torch.scripts import work_ledger

    out_k, err_k = hopper_decode.decode_blocks(*args, block_size=block_size)
    torch.cuda.synchronize()
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(hopper_decode.decode_blocks_torch(*args, block_size)), 1)
    out_p, err_p = plain[0]
    nb = args[0].shape[0]
    verdicts = int(((err_k != 0) == (err_p != 0)).sum())
    if verdicts != nb:
        raise AssertionError(f"{name}: verdicts differ on {nb - verdicts} of {nb} blocks")
    valid = err_k == 0
    diff = (out_k[valid].to(torch.int16) - out_p[valid].to(torch.int16)).abs()
    max_err = int(diff.max()) if diff.numel() else 0
    if max_err:
        raise AssertionError(f"{name}: bytes differ on valid blocks (max abs err {max_err})")
    if expected is not None:
        olen = args[2].cpu()
        for i, want in enumerate(expected):
            got = out_k[i, : int(olen[i])].cpu().numpy().tobytes()
            if want is not None and (got != want or int(err_k[i])):
                raise AssertionError(f"{name}: block {i} does not decode to the expected bytes")
    ms = cuda_ms(lambda: hopper_decode.decode_blocks(*args, block_size=block_size), reps)
    work = work_ledger.decode_work(args[1], args[2], block_size)
    log(
        f"  {name}: {nb} blocks at bs {block_size}, {int(valid.sum())} valid, "
        f"verdicts equal, max abs err {max_err}; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
        f"bound {work['bound_ms']:.4f} ms ({work['bound_by']})"
    )
    return {
        "blocks": nb, "bytes": int(args[2].sum()), "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound": work,
    }


def compare_encode(name, blocks_np, lens_np, device, knobs=None, reps=5):
    """Match (or sweep) and emit kernels vs their plain versions on the same
    CUDA tensors, at the given matcher knobs as ``encode_knobs`` gives them
    (default: the zero-flag config up to 32 KB); returns a stats dict with
    both kernels' times and bounds."""
    import torch

    from pim_compression_tpu_torch.ops import hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.runtime import pipeline
    from pim_compression_tpu_torch.scripts import work_ledger

    knobs = dict(knobs or {})
    sweep = knobs.pop("matcher", "sorted") == "sweep"
    match, match_plain = (
        (hopper_sweep.sweep_match, hopper_sweep.sweep_match_torch) if sweep
        else (hopper_match.match_blocks, hopper_match.match_blocks_torch)
    )
    nb, bs = blocks_np.shape
    cap = pipeline.padded_capacity(bs)
    blocks = torch.from_numpy(blocks_np).to(device)
    lens = torch.from_numpy(lens_np).to(device)
    mlen, mlag = match(blocks, lens, **knobs)
    torch.cuda.synchronize()
    plain = []
    match_plain_ms = cuda_ms(lambda: plain.append(match_plain(blocks, lens, **knobs)), 1)
    err = max(
        int((mlen.to(torch.int32) - plain[0][0].to(torch.int32)).abs().max()),
        int((mlag.to(torch.int32) - plain[0][1].to(torch.int32)).abs().max()),
    )
    if err:
        raise AssertionError(f"{name}: match lengths or lags differ (max abs err {err})")
    plain = []  # free the plain match's output before the plain emit
    comp, sizes = hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap)
    torch.cuda.synchronize()
    emit_plain_ms = cuda_ms(lambda: plain.append(hopper_encode.emit_blocks_torch(blocks, lens, mlen, mlag, cap)), 1)
    if not torch.equal(sizes, plain[0][1]):
        raise AssertionError(f"{name}: sizes differ on {int((sizes != plain[0][1]).sum())} blocks")
    emit_err = int((comp.to(torch.int16) - plain[0][0].to(torch.int16)).abs().max())
    if emit_err:
        raise AssertionError(f"{name}: compressed bytes differ (max abs err {emit_err})")
    match_ms = cuda_ms(lambda: match(blocks, lens, **knobs), reps)
    emit_ms = cuda_ms(lambda: hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap), reps)
    ratio = float(sizes.sum()) / max(1, int(lens.sum()))
    extra = {}
    if sweep:
        match_bound = work_ledger.sweep_work(blocks, lens, mlen, mlag, knobs)
        extra = {k: match_bound.pop(k) for k in ("visited_pairs", "first_word_pairs", "visited_bound")}
    else:
        match_bound = work_ledger.match_work(mlen, knobs)
    match_ops = match_bound["ops"]
    emit_bound = work_ledger.emit_work(lens, bs, cap)
    label = "sweep" if sweep else "match"
    pairs = (f"; {extra['visited_pairs']} pairs visited (bound {extra['visited_bound']['bound_ms']:.4f} ms), "
             f"{extra['first_word_pairs']} with equal first words" if sweep else "")
    log(
        f"  {name}: {nb} blocks at bs {bs}, ratio {ratio:.4f}, lengths, lags, sizes and bytes equal; "
        f"{label} kernel {match_ms:.4f} ms, plain {match_plain_ms:.1f} ms, bound {match_bound['bound_ms']:.4f} ms "
        f"({match_bound['bound_by']}, {match_ops} ops{pairs}); emit kernel {emit_ms:.4f} ms, "
        f"plain {emit_plain_ms:.1f} ms, bound {emit_bound['bound_ms']:.4f} ms ({emit_bound['bound_by']})"
    )
    return {
        "blocks": nb, "bytes": int(lens.sum()), "match_err": err, "emit_err": emit_err, "ratio": ratio,
        "match_ms": match_ms, "match_plain_ms": match_plain_ms,
        "emit_ms": emit_ms, "emit_plain_ms": emit_plain_ms,
        "match_bound": match_bound, "emit_bound": emit_bound, **extra,
    }


def best_of_3(fn, nbytes: int, expected: bytes, what: str):
    """Run fn(timer) three times; each result must equal expected. Returns
    (GB/s, seconds, timer) of the fastest run."""
    from pim_compression_tpu_torch import runtime

    runs = []
    for _ in range(3):
        timer = runtime.PhaseTimer()
        t0 = time.perf_counter()
        out = fn(timer)
        runs.append((time.perf_counter() - t0, timer))
        if bytes(out) != expected:
            raise AssertionError(f"{what}: a repeated run gave other bytes")
    secs, timer = min(runs, key=lambda r: r[0])
    return nbytes / secs / 1e9, secs, timer


def decompress_main(stream: bytes, payload: bytes, bs: int, device, plain: dict) -> dict:
    """The decompress main path at one block size through the "cuda" engine:
    launch count, round trip, best of 3, kernel-only time of one full batch
    (plain time from ``plain``, a compare on a smaller batch)."""
    import torch

    from pim_compression_tpu_torch import native
    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import hopper_decode
    from pim_compression_tpu_torch.runtime import pipeline
    from pim_compression_tpu_torch.scripts import work_ledger

    cfg = TorchCodecConfig(engine="cuda", block_size=bs)
    info = pipeline.scan_frames(stream)
    nb = len(info["payload_off"])
    batches = -(-nb // cfg.batch_blocks)
    log(f"  {nb} blocks at bs {bs}, {len(payload)} bytes")
    timer = runtime.PhaseTimer()
    reset_counts()
    t0 = time.perf_counter()
    out = runtime.decompress(stream, cfg, timer)
    first_s = time.perf_counter() - t0
    launches = hopper_decode.LAUNCHES
    if bytes(out) != payload:
        raise AssertionError(f"decompress bs {bs}: decompressed bytes differ from the payload")
    if launches != batches:
        raise AssertionError(f"decompress bs {bs}: {launches} kernel launches for {batches} batches")
    log(f"  round trip exact; {launches} kernel launches for {batches} batches")
    log(f"  first run: {len(payload) / first_s / 1e9:.3f} GB/s end to end; phases {timer.json()}")
    e2e_gbs, e2e_s, timer = best_of_3(lambda t: runtime.decompress(stream, cfg, t), len(payload), payload, "decompress")
    log(f"  best of 3: {e2e_gbs:.3f} GB/s end to end ({e2e_s * 1e3:.1f} ms); phases {timer.json()}")

    comp, clen, olen = pipeline.blockize_compressed(stream, info)
    n = cfg.batch_blocks
    args = tuple(torch.from_numpy(a[:n]).to(device) for a in (comp, clen, olen))
    kernel_ms = cuda_ms(lambda: hopper_decode.decode_blocks(*args, block_size=bs), 20)
    batch_bytes = int(olen[:n].sum())
    work = work_ledger.decode_work(clen[:n], olen[:n], bs)
    plain_gbs = plain["bytes"] / plain["plain_ms"] / 1e6
    log(f"  kernel only: {kernel_ms:.3f} ms per {n}-block batch, {batch_bytes / kernel_ms / 1e6:.3f} GB/s; "
        f"bound {work['bound_ms']:.4f} ms ({work['bound_by']})")
    log(f"  plain PyTorch: {plain['plain_ms']:.1f} ms per {plain['blocks']}-block batch, {plain_gbs:.4f} GB/s")
    t0 = time.perf_counter()
    host = native.decompress(stream, num_threads=1)
    host_gbs = len(payload) / (time.perf_counter() - t0) / 1e9
    if host != payload:
        raise AssertionError("native host decode differs from the payload")
    log(f"  native host, 1 thread: {host_gbs:.3f} GB/s; end-to-end / host = {e2e_gbs / host_gbs:.3f}")
    return {"launches": launches, "kernel_ms": kernel_ms, "e2e_gbs": e2e_gbs, "bound": work}


def splice(payload: bytes, bs: int) -> bytes:
    """The payload with its RANDOM_BLOCKS replaced by seeded random bytes."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    spliced = bytearray(payload)
    for i in RANDOM_BLOCKS:
        spliced[i * bs : (i + 1) * bs] = rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    return bytes(spliced)


def compress_main(payload: bytes, bs: int, enc_batch: dict, knobs=None, payload_raw: bool = False) -> dict:
    """The compress main path at one block size through the "cuda" engine,
    with RANDOM_BLOCKS replaced by seeded random bytes: launch counts, raw
    blocks, best of 3, the "torch" engine's stream on the GPU, round trips,
    verify=True; kernel times from ``enc_batch`` (a compare on one batch).
    The triage must divert exactly RANDOM_BLOCKS, or with ``payload_raw``
    also blocks of the payload's own random stretches, each of whose bytes
    must carry over 7.5 bits of entropy (text blocks carry about 4.5)."""
    import numpy as np

    from pim_compression_tpu_torch import TorchCodecConfig, native, runtime
    from pim_compression_tpu_torch.ops import hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.runtime import pipeline

    knobs = knobs or {}
    sweep = knobs.get("matcher") == "sweep"
    match_mod, idle_mod = (hopper_sweep, hopper_match) if sweep else (hopper_match, hopper_sweep)
    label = "sweep" if sweep else "match"
    spliced = splice(payload, bs)
    cfg = TorchCodecConfig(engine="cuda", block_size=bs, **knobs)
    nblocks = -(-len(spliced) // bs)
    raw = np.flatnonzero(pipeline.triage_incompressible(*pipeline.blockize_plain(spliced, bs))).tolist()
    extra = sorted(set(raw) - set(RANDOM_BLOCKS))
    if len(raw) - len(extra) != len(RANDOM_BLOCKS):
        raise AssertionError(f"compress bs {bs}: a spliced random block is not diverted")
    if extra and not payload_raw:
        raise AssertionError(f"compress bs {bs}: blocks {extra} diverted besides the spliced ones")
    for i in extra:  # which ones follows the numpy that made the payload
        freq = np.bincount(np.frombuffer(spliced, np.uint8, bs, i * bs), minlength=256) / bs
        bits = float(-(freq[freq > 0] * np.log2(freq[freq > 0])).sum())
        if bits < 7.5:
            raise AssertionError(f"compress bs {bs}: block {i} is diverted, but carries {bits:.3f} bits a byte")
    batches = -(-(nblocks - len(raw)) // cfg.batch_blocks)
    log(f"  {len(spliced)} bytes, {nblocks} blocks at bs {bs}, knobs {knobs or 'zero-flag'}")
    timer = runtime.PhaseTimer()
    reset_counts()
    t0 = time.perf_counter()
    stream = bytes(runtime.compress(spliced, cfg, timer))
    first_s = time.perf_counter() - t0
    launches = (match_mod.LAUNCHES, hopper_encode.LAUNCHES)
    if launches != (batches, batches) or idle_mod.LAUNCHES:
        raise AssertionError(
            f"compress bs {bs}: launches ({label}, emit) {launches} for {batches} batches, "
            f"{idle_mod.LAUNCHES} of the other matcher"
        )
    if timer.notes.get("raw_blocks") != len(raw):
        raise AssertionError(f"compress bs {bs}: {timer.notes.get('raw_blocks')} raw blocks, expected {len(raw)}")
    log(f"  {launches[0]} {label} and {launches[1]} emit launches for {batches} batches; notes {timer.notes}; "
        f"diverted: the {len(RANDOM_BLOCKS)} spliced blocks and payload blocks {extra}")
    log(f"  first run: {len(spliced) / first_s / 1e9:.3f} GB/s end to end; phases {timer.json()}")
    e2e_gbs, e2e_s, timer = best_of_3(lambda t: runtime.compress(spliced, cfg, t), len(spliced), stream, "compress")
    log(f"  best of 3: {e2e_gbs:.3f} GB/s end to end ({e2e_s * 1e3:.1f} ms); phases {timer.json()}")
    t0 = time.perf_counter()
    plain_stream = runtime.compress(spliced, TorchCodecConfig(engine="torch", device="cuda:0", block_size=bs, **knobs))
    plain_s = time.perf_counter() - t0
    if bytes(plain_stream) != stream:
        raise AssertionError(f"compress bs {bs}: the cuda engine's stream differs from the torch engine's")
    log(f"  equal to the torch engine's stream on the GPU ({plain_s:.1f} s, {len(spliced) / plain_s / 1e9:.4f} GB/s)")
    if bytes(runtime.decompress(stream, cfg)) != spliced:
        raise AssertionError(f"compress bs {bs}: the cuda decoder does not give the payload back")
    if native.decompress(stream) != spliced:
        raise AssertionError(f"compress bs {bs}: the native decoder does not give the payload back")
    verified = runtime.compress(spliced, TorchCodecConfig(engine="cuda", block_size=bs, verify=True, **knobs))
    if bytes(verified) != stream:
        raise AssertionError(f"compress bs {bs}: verify=True gave another stream")
    log("  decodes back through the cuda engine and native; verify=True passes")
    t0 = time.perf_counter()
    host_stream = native.compress(spliced, bs, num_threads=1)
    host_gbs = len(spliced) / (time.perf_counter() - t0) / 1e9
    kernel_ms = enc_batch["match_ms"] + enc_batch["emit_ms"]
    log(f"  stream ratio {len(stream) / len(spliced):.4f}; native compress ratio {len(host_stream) / len(spliced):.4f}")
    log(f"  kernel only per {enc_batch['blocks']}-block batch: {label} {enc_batch['match_ms']:.3f} ms + emit "
        f"{enc_batch['emit_ms']:.3f} ms = {enc_batch['bytes'] / kernel_ms / 1e6:.3f} GB/s")
    log(f"  plain PyTorch per batch: {label} {enc_batch['match_plain_ms']:.1f} ms, emit {enc_batch['emit_plain_ms']:.1f} ms")
    log(f"  native host compress, 1 thread: {host_gbs:.3f} GB/s; end-to-end / host = {e2e_gbs / host_gbs:.3f}")
    return {
        "launches": launches, "e2e_gbs": e2e_gbs, "notes": dict(timer.notes), "ratio": len(stream) / len(spliced),
        "stream": stream, "batches": batches,
    }


def pipelined_phase(stream: bytes, payload: bytes, comp: dict) -> dict:
    """Phase 17: both main paths at 32 KB in 128-block batches at depths 1,
    2 and 4; returns each depth's launch counts, GB/s and overlaps."""
    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match
    from pim_compression_tpu_torch.runtime import pipeline, staging
    from pim_compression_tpu_torch.utils.errors import SnappyError

    spliced = splice(payload, BS)
    nb = len(pipeline.scan_frames(stream)["payload_off"])
    dec_batches = -(-nb // PIPE_BATCH)
    comp_batches = -(-(nb - comp["notes"]["raw_blocks"]) // PIPE_BATCH)
    out = {}
    for depth in PIPE_DEPTHS:
        cfg = TorchCodecConfig(engine="cuda", block_size=BS, batch_blocks=PIPE_BATCH, pipeline_depth=depth)
        reset_counts()
        if bytes(runtime.decompress(stream, cfg)) != payload:
            raise AssertionError(f"depth {depth}: decompressed bytes differ from the payload")
        dec_launches = hopper_decode.LAUNCHES
        reset_counts()
        if bytes(runtime.compress(spliced, cfg)) != comp["stream"]:
            raise AssertionError(f"depth {depth}: the stream differs from phase 7's")
        comp_launches = (hopper_match.LAUNCHES, hopper_encode.LAUNCHES)
        if dec_launches != dec_batches or comp_launches != (comp_batches, comp_batches):
            raise AssertionError(f"depth {depth}: launches decode {dec_launches} for {dec_batches} batches, "
                                 f"(match, emit) {comp_launches} for {comp_batches}")
        rec = {"launches": {"decode": dec_launches, "match": comp_launches[0], "emit": comp_launches[1]}}
        for name, fn, nbytes, want in (
            ("decompress", lambda t: runtime.decompress(stream, cfg, t), len(payload), payload),
            ("compress", lambda t: runtime.compress(spliced, cfg, t), len(spliced), comp["stream"]),
        ):
            gbs, secs, timer = best_of_3(fn, nbytes, want, f"{name} depth {depth}")
            staging.TIMELINE = []
            try:
                fn(runtime.PhaseTimer())
                overlap = staging.overlap_ms(staging.TIMELINE)
            finally:
                staging.TIMELINE = None
            if depth >= 2 and not any(overlap):
                raise AssertionError(f"{name} depth {depth}: no batch ran before the one ahead of it was back")
            rec[name] = {"gbs": gbs, "ms": secs * 1e3, "phases_ms": {k: v * 1e3 for k, v in timer.seconds.items()},
                         "overlap_ms": overlap}
            log(f"  depth {depth} {name}: {gbs:.3f} GB/s ({secs * 1e3:.1f} ms); phases {timer.json()}; "
                f"overlap of each batch with the one ahead, ms: {[round(o, 3) for o in overlap]}")
        out[depth] = rec
    deep = TorchCodecConfig(engine="cuda", block_size=BS, batch_blocks=PIPE_BATCH, pipeline_depth=PIPE_DEPTHS[-1])
    if bytes(runtime.compress(spliced, dataclasses.replace(deep, verify=True))) != comp["stream"]:
        raise AssertionError("verify=True at depth 4 gave another stream")
    info = pipeline.scan_frames(stream)
    bad = bytearray(stream)
    for b in PIPE_CORRUPT:
        bad[int(info["payload_off"][b])] = 0x01  # the block opens with a copy: nothing to copy from
    named = {}
    for depth in (1, PIPE_DEPTHS[-1]):
        try:
            runtime.decompress(bytes(bad), dataclasses.replace(deep, pipeline_depth=depth))
        except SnappyError as e:
            named[depth] = str(e)
        else:
            raise AssertionError(f"depth {depth}: corrupt blocks decoded without an error")
    if named[1] != named[PIPE_DEPTHS[-1]] or f"block {PIPE_CORRUPT[0]} " not in named[1]:
        raise AssertionError(f"corrupt blocks named differently: {named}")
    log(f"  verify=True passes at depth {PIPE_DEPTHS[-1]}; corrupt blocks {PIPE_CORRUPT} rejected at depths 1 and "
        f"{PIPE_DEPTHS[-1]} alike: {named[1]}")
    return out


def shard_launches(blocks: int, batch_blocks: int, entries: int) -> int:
    """Launches of each kernel for ``blocks`` device blocks over ``entries``
    mesh entries: one per non-empty shard of every batch."""
    from pim_compression_tpu_torch.runtime import api

    per = batch_blocks * entries
    return sum(len(api._shards(i, blocks, batch_blocks, entries)) for i in range(-(-blocks // per)))


def devices_phase(payload: bytes, stream: bytes, comp: dict, dec: dict, card: str) -> dict:
    """Phase 19: devices and processes. (a) phase 7's spliced payload and
    phase 4's stream through 2 mesh entries (the first two cards, or two
    entries on cuda:0 where there is one card); (b) two OS processes on a
    gloo group, each on its card by local rank, running compress_to_file
    and decompress_to_file; (c) dryrun_multichip over 2 and 8 entries.
    Returns the records for its JSON line."""
    import torch

    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.parallel import dryrun
    from pim_compression_tpu_torch.runtime import pipeline
    from pim_compression_tpu_torch.scripts import multiproc_worker

    spliced = splice(payload, BS)
    nb = len(pipeline.scan_frames(stream)["payload_off"])
    count = torch.cuda.device_count()
    if count >= 2:  # the real split: mesh_devices picks the first two cards
        cfg, entries = TorchCodecConfig(engine="cuda", block_size=BS, mesh_devices=2), None
        where = ["cuda:0", "cuda:1"]
    else:
        cfg, entries = TorchCodecConfig(engine="cuda", block_size=BS), [torch.device("cuda:0")] * 2
        where = ["cuda:0", "cuda:0"]
    want = {"decode": shard_launches(nb, cfg.batch_blocks, 2),
            "match": shard_launches(nb - comp["notes"]["raw_blocks"], cfg.batch_blocks, 2)}
    out = {"card": card, "count": count, "split": {"entries": where, "shards": want}}

    # (a) The split.
    reset_counts()
    split_stream = bytes(runtime.compress(spliced, cfg, _devices=entries))
    launches = {"match": hopper_match.LAUNCHES, "emit": hopper_encode.LAUNCHES, "sweep": hopper_sweep.LAUNCHES}
    reset_counts()
    split_out = runtime.decompress(stream, cfg, _devices=entries)
    launches["decode"] = hopper_decode.LAUNCHES
    if split_stream != comp["stream"]:
        raise AssertionError("split over 2 entries: the stream differs from phase 7's")
    if bytes(split_out) != payload:
        raise AssertionError("split over 2 entries: decompressed bytes differ from the payload")
    if launches != {"match": want["match"], "emit": want["match"], "sweep": 0, "decode": want["decode"]}:
        raise AssertionError(f"split over 2 entries: launches {launches}, shards {want}")
    out["split"]["launches"] = launches
    for name, fn, nbytes, expected, single in (
        ("compress", lambda t: runtime.compress(spliced, cfg, t, _devices=entries), len(spliced), comp["stream"],
         comp["e2e_gbs"]),
        ("decompress", lambda t: runtime.decompress(stream, cfg, t, _devices=entries), len(payload), payload,
         dec["e2e_gbs"]),
    ):
        gbs, secs, timer = best_of_3(fn, nbytes, expected, f"split {name}")
        out["split"][name] = {"gbs": gbs, "ms": secs * 1e3, "one_entry_gbs": single,
                              "phases_ms": {k: v * 1e3 for k, v in timer.seconds.items()}}
        log(f"  (a) {name} over {where}: {gbs:.3f} GB/s best of 3 ({secs * 1e3:.1f} ms; one entry, phase "
            f"{7 if name == 'compress' else 4}: {single:.3f}); phases {timer.json()}")
    log(f"  (a) streams equal phase 7's, round trip exact; launches {launches} for shards {want}")

    # (b) Two processes on a gloo group.
    with tempfile.TemporaryDirectory() as tmp:
        src, cooperative, decoded = (os.path.join(tmp, n) for n in ("in.bin", "out.snappy", "dec.bin"))
        with open(src, "wb") as f:
            f.write(spliced)
        t0 = time.perf_counter()
        ranks, hwm = held_launcher_hwm(
            lambda: multiproc_worker.run_ranks(2, src, cooperative, decoded, BS, "cuda", timeout=180))
        procs_s = time.perf_counter() - t0
        with open(cooperative, "rb") as f:
            if f.read() != comp["stream"]:
                raise AssertionError("two processes: the file differs from phase 7's stream")
        with open(decoded, "rb") as f:
            if f.read() != spliced:
                raise AssertionError("two processes: the decompressed file differs from the payload")
    ranges = [tuple(r["process_blocks"]) for r in ranks]
    if ranges[0][0] != 0 or ranges[0][1] != ranges[1][0] or ranges[1][1] != nb:
        raise AssertionError(f"two processes: ranges {ranges} are not disjoint or do not cover {nb} blocks")
    if any(not (r["launches"]["match"] and r["launches"]["emit"] and r["launches"]["decode"]) for r in ranks):
        raise AssertionError(f"two processes: a rank launched no kernel: {[r['launches'] for r in ranks]}")
    check_rank_peaks("two processes", [r["peak_rss_mb"] for r in ranks], hwm)
    log(f"  (b) ranks' peak RSS {[round(r['peak_rss_mb'], 1) for r in ranks]} MB (ru_maxrss "
        f"{[round(r['maxrss_mb'], 1) for r in ranks]}, resident at the end {[r['rss_mb'] for r in ranks]}), below "
        f"half of chip_smoke.py's own {hwm:.1f} MB, which held {HELD_BYTES >> 20} MB of touched pages")
    procs = {"ranks": ranks, "seconds": procs_s, "launcher_peak_rss_mb": hwm}
    for name, single in (("compress", comp["e2e_gbs"]), ("decompress", dec["e2e_gbs"])):
        wall = max(r[f"{name}_wall_s"] for r in ranks)
        warm = max(r[f"{name}_wall_s"] - r[f"{name}_phases_s"]["compile"] for r in ranks)
        procs[name] = {"gbs": len(spliced) / wall / 1e9, "gbs_less_compile": len(spliced) / warm / 1e9,
                       "slowest_wall_s": wall, "one_process_gbs": single}
        log(f"  (b) {name}, 2 processes: {procs[name]['gbs']:.3f} GB/s over the slowest rank's wall "
            f"({wall * 1e3:.1f} ms; {procs[name]['gbs_less_compile']:.3f} less its compile phase); one process, "
            f"phase {7 if name == 'compress' else 4}: {single:.3f}")
    for r in ranks:
        log(f"  (b) rank {r['rank']}: blocks {r['process_blocks']}, launches {r['launches']}, "
            f"compress phases {json.dumps({k: round(v, 4) for k, v in r['compress_phases_s'].items()})}, "
            f"decompress phases {json.dumps({k: round(v, 4) for k, v in r['decompress_phases_s'].items()})}, "
            f"peak RSS {r['peak_rss_mb']:.0f} MB")
    log(f"  (b) file equals phase 7's stream, round trip exact, ranges {ranges}; {procs_s:.1f} s with start-up")
    out["processes"] = procs

    # (c) The dry run.
    out["dryrun"] = {}
    for n in (2, 8):
        reset_counts()
        out["dryrun"][n] = dryrun.dryrun_multichip(n)
    return out


def tooling_phase(payload: bytes, comp: dict, cli_runs: dict, card: str) -> dict:
    """Phase 20: the port's tooling on the card. (a) the entry point, in
    this process and in a fresh one; (b) the host-phase bench; (c) the
    multi-process bench over 1 and 2 ranks; (d) the benchmark runner; (e)
    the corpus check; (f) the output parser on phase 14's CLI stdout.
    Returns the records for its JSON line; the in-process launches and the
    ranks' are under "launches"."""
    import contextlib
    import io

    import torch

    from pim_compression_tpu_torch.format import oracle
    from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.parallel import dryrun, mesh
    from pim_compression_tpu_torch.scripts import (
        corpus_check, host_phase_bench, multiproc_bench, parse_output, run_benchmarks,
    )
    from pim_compression_tpu_torch.utils import streams

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    out = {"card": card}
    reset_counts()

    # (a) The entry: the oracle's three blocks, every error bit 0.
    t0 = time.perf_counter()
    fn, args = dryrun.entry()
    dec_out, err = fn(*args)
    torch.cuda.synchronize()
    comp_h, clen_h, olen_h = (t.cpu().numpy() for t in args)
    plain = b"".join(oracle.decompress(streams.frame_block(comp_h[i, :c].tobytes(), int(n), BS))
                     for i, (c, n) in enumerate(zip(clen_h, olen_h)))
    got = b"".join(dec_out[i, : int(n)].cpu().numpy().tobytes() for i, n in enumerate(olen_h))
    if got != plain or bool(err.any()):
        raise AssertionError(f"entry: the decode differs from the oracle's, or error bits {err.tolist()}")
    proc = subprocess.run([sys.executable, "-m", "pim_compression_tpu_torch.parallel.dryrun"], capture_output=True,
                          text=True, cwd=root, env=env, timeout=300)
    if proc.returncode != 0 or "entry OK: (3, 32768) 0" not in proc.stdout:
        raise AssertionError(f"python -m ...parallel.dryrun: {proc.returncode} {proc.stdout!r} {proc.stderr[-2000:]}")
    out["entry"] = {"blocks": int(args[0].shape[0]), "bytes": len(plain), "seconds": time.perf_counter() - t0,
                    "process_stdout": proc.stdout.strip()}
    log(f"  (a) entry: {args[0].shape[0]} blocks, {len(plain)} bytes equal the oracle's, error bits 0; "
        f"a fresh process printed {proc.stdout.strip()!r} ({out['entry']['seconds']:.1f} s)")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) The host phases.
        t0 = time.perf_counter()
        out["host_phases"] = host_phase_bench.run(mb=32, device="cuda:0")
        log(f"  (b) host phases at 32 MB ({card}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["host_phases"].items() if k.endswith("_gbps"))
            + f" GB/s ({time.perf_counter() - t0:.1f} s)")

        # (c) The multi-process bench on phase 7's payload size.
        t0 = time.perf_counter()
        spliced = splice(payload, BS)
        mb = len(spliced) // 1_000_000
        (rows, ranks), hwm = held_launcher_hwm(lambda: multiproc_bench.run(
            ["--procs", "1,2", "--engine", "cuda", "--repeat", "1", "--mb", str(mb), "--out",
             os.path.join(tmp, "procs.csv")]))
        peaks = [r["peak_rss_mb"] for recs in ranks.values() for r in recs]
        resident = [r["rss_mb"] for recs in ranks.values() for r in recs]
        check_rank_peaks("multiproc_bench", peaks, hwm)
        rank_launches = {k: sum(r["launches"][k] for recs in ranks.values() for r in recs)
                         for k in ("match", "emit", "sweep", "decode")}
        out["multiproc"] = {"rows": rows, "rank_peak_rss_mb": peaks, "rank_rss_mb": resident,
                            "launcher_peak_rss_mb": hwm,
                            "rank_launches": rank_launches, "seconds": time.perf_counter() - t0}
        for r in rows:
            log(f"  (c) {r['procs']} process(es), {mb} MB on cuda: round trip exact; {r['gbps']:.3f} GB/s over the "
                f"codec's phases (compress {r['compress_s'] * 1e3:.1f} ms, decompress {r['decompress_s'] * 1e3:.1f} "
                f"ms), wall {r['wall_s']:.1f} s, speedup {r['speedup']:.3f}, efficiency {r['efficiency']:.3f}")
        log(f"  (c) ranks' peak RSS {[round(p, 1) for p in peaks]} MB (resident at the end {resident}), below half "
            f"of chip_smoke.py's own {hwm:.1f} MB, which held {HELD_BYTES >> 20} MB; ranks' launches {rank_launches} "
            f"({out['multiproc']['seconds']:.1f} s)")

        # (d) The benchmark runner over mesh sizes 1 and 2.
        t0 = time.perf_counter()
        # --rungs 4,16 makes each point's config the zero-flag config of phase 7.
        argv = ["--engines", "native,cuda", "--synth-sizes", "36", "--block-sizes", str(BS), "--mesh-sizes", "1,2",
                "--rungs", "4,16", "--iters", "1", "--out", os.path.join(tmp, "bench.csv")]
        kept = {}
        rows = run_benchmarks.run(argv, keep=kept)
        entries = {n: [str(d) for d in mesh.local_devices("cuda", None, n)] for n in (1, 2)}
        (_, synth), = run_benchmarks.inputs(run_benchmarks.parse(argv))
        # The runner's payload is seeded text of its own, not phase 7's, so
        # each cuda point's own stream must decode through the oracle, at its
        # row's size.
        cuda_rows = [r for r in rows if r["engine"] == "cuda" and r["direction"] == "compress"]
        for r in cuda_rows:
            stream = kept[r["file"], "cuda", r["block_size"], r["matcher"], r["mesh_devices"], r["prev_k"],
                          r["sel_cap"]]
            if len(stream) != r["compressed_bytes"] or oracle.decompress(stream) != synth:
                raise AssertionError(f"run_benchmarks: the cuda stream of mesh {r['mesh_devices']} "
                                     f"({len(stream)} bytes) does not decode through the oracle")
        if len(cuda_rows) != 2:
            raise AssertionError(f"run_benchmarks: {len(cuda_rows)} cuda compress rows, not 2")
        out["run_benchmarks"] = {"rows": rows, "mesh_entries": entries, "seconds": time.perf_counter() - t0}
        for r in rows:
            log(f"  (d) {r['file']} {r['engine']} mesh {r['mesh_devices']} {r['direction']}: {r['gbps']:.3f} GB/s, "
                f"{r['compressed_bytes']} bytes")
        log(f"  (d) mesh_devices 1 and 2 take {entries}; round trips exact; the oracle decodes each cuda point's "
            f"stream ({sorted({r['compressed_bytes'] for r in cuda_rows})} bytes) to the input "
            f"({out['run_benchmarks']['seconds']:.1f} s)")

    # (e) The corpus check, which checks no file where the corpus is absent.
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        rc = corpus_check.main([])
    last = report.getvalue().strip().splitlines()[-1]
    if rc != 0 or not last.endswith("PASS"):
        raise AssertionError(f"corpus_check: rc {rc}, {last!r}")
    out["corpus_check"] = last
    log(f"  (e) corpus_check on cuda: {last!r}")

    # (f) The parser on phase 14's CLI stdout: the JSON line's phases, and the
    # human lines' phases and ratio to their printed digits.
    for name, run in cli_runs.items():
        record = json.loads([line for line in run["stdout"].splitlines() if line.startswith("{")][-1])
        parsed = parse_output.parse(run["stdout"])
        human = parse_output.parse("\n".join(line for line in run["stdout"].splitlines() if not line.startswith("{")))
        ratio = 1 - record["compressed_bytes"] / record["original_bytes"]
        if (parsed["phases_s"] != record["phases_s"] or human["phases_s"].keys() != record["phases_s"].keys()
                or any(abs(human["phases_s"][k] - v) > 5e-7 for k, v in record["phases_s"].items())
                or abs(human["ratio"] - ratio) > 5e-7):
            raise AssertionError(f"parse_output on CLI {name}: {parsed} against {record}")
    log(f"  (f) parse_output gives the JSON line's phases and ratio on {len(cli_runs)} CLI runs")

    out["launches"] = {"in_process": {"match": hopper_match.LAUNCHES, "emit": hopper_encode.LAUNCHES,
                                      "sweep": hopper_sweep.LAUNCHES, "decode": hopper_decode.LAUNCHES},
                       "ranks": rank_launches}
    missing = [k for k in ("match", "emit", "decode") if not out["launches"]["in_process"][k]]
    if missing:
        raise AssertionError(f"phase 20 launched no {missing} kernel in this process: {out['launches']}")
    log(f"  launches: {out['launches']}")
    return out


def measure_phase(payload: bytes, wide_payload: bytes, dec: dict, wide_dec: dict, enc_batch: dict,
                  wide_enc_batch: dict, card: str) -> dict:
    """Phase 21: the measurement tools (pim_compression_tpu_torch/scripts/)
    on the card. (a) the work ledger on the main batches; (b) kernel_attrib
    on full batches; (c) pipeline_times at 32 KB; (d) spec_ratio on 8 MB,
    the cuda engine against the torch engine on the card; (e) validate
    --quick on config (a). Returns the records for its JSON line and the
    phase's launches; raises on any failure."""
    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.scripts import kernel_attrib, pipeline_times, spec_ratio, validate, work_ledger

    payloads = {BS: payload, WIDE_BS: wide_payload}
    out = {"card": card, "seconds": {}}
    reset_counts()

    # (a) The ledger's port rows on the main batches: the phase-6 and phase-9
    # batches (the kernels line's and phase 13's match and emit bounds) and
    # the phase-4 and phase-10 decode batches.
    t0 = time.perf_counter()
    ledger = work_ledger.run("cuda:0", rows="port", payloads=payloads, decode_sizes=(BS, WIDE_BS))
    rows = {(r["kernel"], r["config"]): r for r in ledger["rows"]}
    want = {("decode", f"{BS} decode"): dec["bound"], ("decode", f"{WIDE_BS} decode"): wide_dec["bound"],
            ("match", f"{BS} zero-flag"): enc_batch["match_bound"], ("emit", f"{BS} zero-flag"): enc_batch["emit_bound"],
            ("match", f"{WIDE_BS} zero-flag"): wide_enc_batch["match_bound"],
            ("emit", f"{WIDE_BS} zero-flag"): wide_enc_batch["emit_bound"]}
    for key, bound in want.items():
        if rows[key]["bound_ms"] != bound["bound_ms"] or rows[key]["ops"] != bound["ops"]:
            raise AssertionError(f"work ledger {key}: {rows[key]['bound_ms']} ms, {rows[key]['ops']} ops; the "
                                 f"kernels line's {bound['bound_ms']} ms, {bound['ops']} ops")
    out["ledger"] = ledger["rows"]
    out["seconds"]["a"] = time.perf_counter() - t0
    log(f"  (a) work ledger: {len(ledger['rows'])} rows; the decode, match and emit bounds of phases 4, 6, 9 "
        f"and 10 equal ({out['seconds']['a']:.1f} s)")
    for r in ledger["rows"]:
        log(f"  (a) {r['kernel']} {r['config']}: bound {r['bound_ms']:.4f} ms ({r['bound_by']}), ceiling "
            f"{r['ceiling_gbps']:.1f} GB/s")

    # (b) Attribution on full batches: the parts and the glue add to the whole.
    t0 = time.perf_counter()
    attrib = kernel_attrib.run("cuda:0", names=[f"{BS} zero-flag", "config (e)"], decode_sizes=(BS,), fixed=False,
                               payloads=payloads)
    for r in attrib["records"]:
        if abs(r["sum_over_whole"] - 1) > 0.05:
            raise AssertionError(f"kernel_attrib {r['config']}: parts {r['sum_ms']} ms against the whole "
                                 f"{r['whole_ms']} ms")
        log(f"  (b) {r['config']}: whole {r['whole_ms']:.4f} ms, parts {r['sum_ms']:.4f} ms "
            f"({r['sum_over_whole']:.4f}; calls with a host gap: {r['host_gap_calls']}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["parts_ms"].items())
            + "; paced: " + ", ".join(f"{k} {v:.4f}" for k, v in r["paced"]["parts_ms"].items()))
    out["attrib"] = attrib["records"]
    out["seconds"]["b"] = time.perf_counter() - t0

    # (c) The pipelines' slope at 32 KB beside the ledger's bound.
    t0 = time.perf_counter()
    out["pipeline"] = pipeline_times.run("cuda:0", names=[f"{BS} zero-flag"], payloads=payloads)["records"]
    for r in out["pipeline"]:
        if not r["device_gbps"]:
            raise AssertionError(f"pipeline_times {r['direction']}: no slope ({r['per_group_s']} s a group)")
        log(f"  (c) {r['direction']} {BS}: slope {r['device_gbps']:.3f} GB/s, bound {r['bound_gbps']:.1f} GB/s, "
            f"ratio {r['slope_over_bound']:.4f}")
    out["seconds"]["c"] = time.perf_counter() - t0

    # (d) The ratio tool on 8 MB: the kernels' total is the plain versions'
    # on the card, and the length of the runtime's stream without triage.
    t0 = time.perf_counter()
    sub = payload[: 8 << 20]
    cfg = spec_ratio.parse_config("rungs=4,16 rung_pick=1 ext_cap=48 neighbor=1 max_lag=8192")  # the zero-flag config
    total, cuda_s = spec_ratio.measure(sub, BS, cfg, engine="cuda")
    plain_total, plain_s = spec_ratio.measure(sub, BS, cfg, engine="torch", device="cuda:0")
    stream = runtime.compress(sub, TorchCodecConfig(engine="cuda", block_size=BS, raw_triage=False))
    if not total == plain_total == len(stream):
        raise AssertionError(f"spec_ratio: {total} bytes on cuda, {plain_total} on torch, the runtime's {len(stream)}")
    out["spec_ratio"] = {"bytes": len(sub), "total": total, "ratio": 1 - total / len(sub), "cuda_s": cuda_s,
                         "torch_s": plain_s}
    out["seconds"]["d"] = time.perf_counter() - t0
    log(f"  (d) spec_ratio, {len(sub)} bytes, zero-flag: {total} bytes (ratio {1 - total / len(sub):.4f}) on cuda "
        f"({cuda_s:.2f} s) and on the torch engine on the card ({plain_s:.2f} s), the runtime's stream length")

    # (e) Validation of config (a), quick.
    t0 = time.perf_counter()
    res = validate.run(validate.parse(["--bs", str(BS), "--matcher", "sorted", "--prev-k", "4", "--sel-cap", "16",
                                       "--stride2-min", "16", "--ext-cap", "48", "--neighbor", "--max-lag", "8192",
                                       "--quick", "--device", "cuda:0"]))
    errs = (res["decode_max_abs_err"], res["match_max_abs_err"], res["emit_max_abs_err"])
    if any(errs) or not (res["decode_bit_exact"] and res["encode_round_trip"] and res["encode_decodes_ok"]):
        raise AssertionError(f"validate config (a): {res}")
    out["validate"] = res
    out["seconds"]["e"] = time.perf_counter() - t0
    log(f"  (e) validate --quick, config (a): kernels equal their plain versions; decode {res['decode_gbps']:.3f} "
        f"GB/s, encode {res['encode_gbps']:.3f} GB/s ({res['match_ms']:.3f} + {res['emit_ms']:.3f} ms), ratio "
        f"{res['encode_ratio']:.4f}, round trip exact ({out['seconds']['e']:.1f} s)")

    out["launches"] = {"match": hopper_match.LAUNCHES, "emit": hopper_encode.LAUNCHES, "sweep": hopper_sweep.LAUNCHES,
                       "decode": hopper_decode.LAUNCHES}
    missing = [k for k, n in out["launches"].items() if not n]
    if missing:
        raise AssertionError(f"phase 21 launched no {missing} kernel: {out['launches']}")
    log(f"  launches: {out['launches']}")
    return out


def portable_batch(blocks, lens, bs: int, device) -> dict:
    """One batch of the portable engine's functions on the card: the
    device time of encode_blocks and decode_blocks (CUDA events, mean of 3
    after a first call) and the peak memory each allocates beyond its
    resident inputs (``torch.cuda.max_memory_allocated``)."""
    import torch

    from pim_compression_tpu_torch.ops import decode as decode_ops, encode as encode_ops

    blocks_d, lens_d = torch.from_numpy(blocks).to(device), torch.from_numpy(lens).to(device)
    rec = {"blocks": len(lens), "bytes": int(lens.sum())}
    for name, fn in (
        ("encode", lambda: encode_ops.encode_blocks(blocks_d, lens_d, block_size=bs)),
        ("decode", lambda: decode_ops.decode_blocks(comp_d, sizes_d, lens_d, block_size=bs)),
    ):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        result = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - base
        if name == "encode":
            comp_d, sizes_d = result
        else:
            out_d, err_d = result
        del result
        rec[name] = {"ms": cuda_ms(fn, 3), "peak_mb": peak / 2**20}
    if bool(err_d.any()) or not torch.equal(out_d, blocks_d):
        raise AssertionError(f"portable bs {bs}: a batch does not decode back to its blocks")
    rec["total_mb"] = torch.cuda.get_device_properties(device).total_memory / 2**20
    return rec


def portable_phase(payload: bytes, wide_payload: bytes, stream: bytes, wide_stream: bytes, device, card: str) -> dict:
    """Phase 18: the portable engine (ops/{primitives,decode,encode}.py,
    plain PyTorch ops with no hand kernel) on the card: its compress and
    decompress at 32 KB and 64 KB, round trips, one batch's time and peak
    memory, card against CPU, block mutants, and the cuda engine's
    envelope fallback to it. Returns the records for its JSON line."""
    import numpy as np
    import torch

    from pim_compression_tpu_torch import TorchCodecConfig, native, runtime
    from pim_compression_tpu_torch.ops import decode as decode_ops, encode as encode_ops
    from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.runtime import pipeline
    from pim_compression_tpu_torch.utils import streams
    from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

    out = {"card": card}
    for bs, plain, native_stream, cpu_rows in ((BS, payload, stream, 64), (WIDE_BS, wide_payload, wide_stream, 16)):
        spliced = splice(plain, bs)
        cfg = TorchCodecConfig(engine="portable", block_size=bs)
        timer = runtime.PhaseTimer()
        t0 = time.perf_counter()
        comp = bytes(runtime.compress(spliced, cfg, timer))
        first_s = time.perf_counter() - t0
        raw = timer.notes.get("raw_blocks", 0)
        if raw < len(RANDOM_BLOCKS) or "engine_fallback" in timer.notes:
            raise AssertionError(f"portable bs {bs}: notes {timer.notes}")
        if native.decompress(comp) != spliced:
            raise AssertionError(f"portable bs {bs}: the native decoder does not give the payload back")
        if bytes(runtime.decompress(comp, TorchCodecConfig(engine="cuda", block_size=bs))) != spliced:
            raise AssertionError(f"portable bs {bs}: the cuda engine's decoder does not give the payload back")
        if bytes(runtime.decompress(comp, cfg)) != spliced:
            raise AssertionError(f"portable bs {bs}: the portable decoder does not give the payload back")
        log(f"  bs {bs}: {len(spliced)} bytes compressed, {raw} raw blocks, ratio {len(comp) / len(spliced):.4f}; "
            f"first run {len(spliced) / first_s / 1e9:.3f} GB/s; decodes back through native, cuda and portable")
        c_gbs, c_s, c_timer = best_of_3(lambda t: runtime.compress(spliced, cfg, t), len(spliced), comp,
                                        f"portable compress bs {bs}")
        d_gbs, d_s, d_timer = best_of_3(lambda t: runtime.decompress(native_stream, cfg, t), len(plain), plain,
                                        f"portable decompress bs {bs}")
        log(f"  bs {bs} compress best of 3: {c_gbs:.3f} GB/s ({c_s * 1e3:.1f} ms); phases {c_timer.json()}")
        log(f"  bs {bs} decompress (the native stream) best of 3: {d_gbs:.3f} GB/s ({d_s * 1e3:.1f} ms); "
            f"phases {d_timer.json()}")
        blocks, lens = pipeline.blockize_plain(spliced, bs)
        batch = portable_batch(blocks[: cfg.batch_blocks], lens[: cfg.batch_blocks], bs, device)
        log(f"  bs {bs}, one {batch['blocks']}-block batch on the card ({card}): encode {batch['encode']['ms']:.2f} ms, "
            f"peak {batch['encode']['peak_mb']:.0f} MiB; decode {batch['decode']['ms']:.2f} ms, peak "
            f"{batch['decode']['peak_mb']:.0f} MiB, of {batch['total_mb']:.0f} MiB")
        # The same function on the card and on the CPU.
        rows = [torch.from_numpy(a[:cpu_rows]) for a in (blocks, lens)]
        comp_g, sizes_g = encode_ops.encode_blocks(*(r.to(device) for r in rows), block_size=bs)
        comp_c, sizes_c = encode_ops.encode_blocks(*rows, block_size=bs)
        if not (torch.equal(comp_g.cpu(), comp_c) and torch.equal(sizes_g.cpu(), sizes_c)):
            raise AssertionError(f"portable bs {bs}: encode_blocks differs between the card and the CPU")
        dec_g = decode_ops.decode_blocks(comp_g, sizes_g, rows[1].to(device), block_size=bs)
        dec_c = decode_ops.decode_blocks(comp_c, sizes_c, rows[1], block_size=bs)
        if not all(torch.equal(g.cpu(), c) for g, c in zip(dec_g, dec_c)):
            raise AssertionError(f"portable bs {bs}: decode_blocks differs between the card and the CPU")
        log(f"  bs {bs}: the first {cpu_rows} blocks encode and decode alike on the card and the CPU")
        out[str(bs)] = {
            "compress_gbs": c_gbs, "compress_ms": c_s * 1e3, "compress_phases_ms": {k: v * 1e3 for k, v in c_timer.seconds.items()},
            "decompress_gbs": d_gbs, "decompress_ms": d_s * 1e3,
            "decompress_phases_ms": {k: v * 1e3 for k, v in d_timer.seconds.items()},
            "ratio": len(comp) / len(spliced), "batch": batch,
        }

    # Block mutants at 1024: the card's verdicts and bytes are the CPU's.
    sub = payload[: 64 * 1024]
    base = streams.hand_blocks(1024) + stream_blocks(native.compress(sub, 1024))
    muts = streams.block_mutants(base, random.Random(SEED + 18), 256, 1024)
    args = to_device(base + muts, 1024, device)
    got = decode_ops.decode_blocks(*args, block_size=1024)
    want = decode_ops.decode_blocks(*(a.cpu() for a in args), block_size=1024)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("portable: block mutants decode differently on the card and the CPU")
    log(f"  {len(base)} blocks and {len(muts)} mutants at bs 1024: out and err equal on the card and the CPU "
        f"({int((want[1][len(base):] != 0).sum())} mutants flagged)")

    # The cuda engine's envelope fallback: the portable stream on the card,
    # a warning and a note, no kernel launched; strict_engine raises first.
    import warnings

    fb_data = payload[: 2 << 20]
    mods = (hopper_decode, hopper_match, hopper_sweep, hopper_encode)
    out["fallback"] = {}
    for knobs in (dict(block_size=BS, matcher="sweep"), dict(block_size=128)):
        want_stream = bytes(runtime.compress(fb_data, TorchCodecConfig(engine="portable", block_size=knobs["block_size"])))
        timer = runtime.PhaseTimer()
        reset_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got_stream = bytes(runtime.compress(fb_data, TorchCodecConfig(engine="cuda", **knobs), timer))
        note = timer.notes.get("engine_fallback", "")
        if got_stream != want_stream or not note.startswith("cuda->portable ("):
            raise AssertionError(f"fallback {knobs}: stream equal {got_stream == want_stream}, note {note!r}")
        if not any("falling back to the portable engine" in str(w.message) for w in caught):
            raise AssertionError(f"fallback {knobs}: no warning")
        if any(m.LAUNCHES for m in mods):
            raise AssertionError(f"fallback {knobs}: a kernel was launched")
        reset_counts()
        try:
            runtime.compress(fb_data, TorchCodecConfig(engine="cuda", strict_engine=True, **knobs))
        except SnappyError as e:
            if e.status != SnappyStatus.BAD_ARGUMENT or any(m.LAUNCHES for m in mods):
                raise AssertionError(f"strict {knobs}: {e.status}, launches {[m.LAUNCHES for m in mods]}") from e
        else:
            raise AssertionError(f"strict {knobs}: compressed")
        log(f"  cuda engine {knobs}: falls back with a warning, note {note!r}, the portable stream, no kernel "
            f"launched; strict_engine raises before any launch")
        out["fallback"][json.dumps(knobs)] = note
    return out


def run_cli(argv: list[str], cwd: str) -> tuple[dict, str]:
    """One run of the port's CLI in a process of its own; returns (its
    kernels' launch counts and exit code, its stdout) and raises if it
    failed. Prints its wall time."""
    root = os.path.dirname(os.path.abspath(__file__))  # the checkout: its package, run from anywhere
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_RUN, *argv], capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    counts = json.loads(lines[-1]) if lines and lines[-1].startswith('{"rc"') else {"rc": None}
    if proc.returncode != 0 or counts["rc"] != 0:
        raise AssertionError(f"CLI {argv} failed ({proc.returncode}): {proc.stderr[-2000:]}")
    log(f"  CLI {' '.join(argv)}: {secs:.2f} s in its process, launches {counts}")
    return counts, "\n".join(lines[:-1])


def cli_round_trip(name: str, argv: list[str], payload: bytes, bs: int, want: bytes, tmp: str, batches: int) -> dict:
    """Compress the payload through the CLI with argv's matcher flags; the
    stream must equal ``want``, name the cuda engine in its JSON line, and
    decompress back through the CLI and the native codec; the match and
    emit kernels must run once per batch and the decode kernel once per
    decompress batch. Returns the launch counts of both runs."""
    from pim_compression_tpu_torch import native

    src, comp, out = (os.path.join(tmp, f"{name}.{ext}") for ext in ("in", "snappy", "out"))
    with open(src, "wb") as f:
        f.write(payload)
    counts, stdout = run_cli(["-c", "-b", str(bs), "--json", *argv, "-i", src, "-o", comp], tmp)
    metrics = json.loads([line for line in stdout.splitlines() if line.startswith("{")][-1])
    if metrics["engine"] != "cuda" or metrics["original_bytes"] != len(payload):
        raise AssertionError(f"CLI {name}: JSON line {metrics}")
    if (counts["match"], counts["emit"], counts["sweep"]) != (batches, batches, 0):
        raise AssertionError(f"CLI {name}: launches {counts} for {batches} batches")
    with open(comp, "rb") as f:
        stream = f.read()
    if stream != want:
        raise AssertionError(f"CLI {name}: the stream differs from runtime.compress's")
    dec_counts, _ = run_cli(["-i", comp, "-o", out], tmp)
    with open(out, "rb") as f:
        if f.read() != payload:
            raise AssertionError(f"CLI {name}: the CLI's decompress does not give the payload back")
    nb = -(-len(payload) // bs)
    if dec_counts["decode"] != -(-nb // 1024) or dec_counts["match"]:
        raise AssertionError(f"CLI {name}: decompress launches {dec_counts}")
    if native.decompress(stream) != payload:
        raise AssertionError(f"CLI {name}: the native decoder does not give the payload back")
    phases = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in metrics["phases_s"].items())
    log(f"  CLI {name}: stream equal ({len(stream)} bytes, ratio {len(stream) / len(payload):.4f}), "
        f"{metrics['total_s']:.3f} s in its phases ({len(payload) / metrics['total_s'] / 1e9:.3f} GB/s; ms: {phases}), "
        "decompresses back through the CLI and native")
    return {"compress": counts, "decompress": dec_counts, "gbs": len(payload) / metrics["total_s"] / 1e9,
            "phases": metrics["phases_s"], "stdout": stdout}


def compare_probe(name: str, kernel, plain, args, reps: int, timing_args=None) -> dict:
    """A probe kernel against its plain version on the same CUDA tensors,
    exactly; returns max_abs_err and both times (ms; the kernel's mean of
    reps launches, taking ``timing_args`` in turn where given, every output
    kept)."""
    import itertools

    import torch

    from pim_compression_tpu_torch.scripts import common

    out_k = kernel(*args)
    torch.cuda.synchronize()
    got = []
    plain_ms = cuda_ms(lambda: got.append(plain(*args)), 1)
    err = int((out_k.long() - got[0].long()).abs().max())
    if out_k.shape != got[0].shape or err:
        raise AssertionError(f"{name}: kernel and plain version differ (max abs err {err})")
    turn, kept = itertools.cycle(timing_args or [args]), []
    ms = common.event_seconds(lambda: kept.append(kernel(*next(turn))), reps) * 1e3  # device time, launches queued
    log(f"  {name}: equal; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def probes_phase(device) -> dict:
    """Phase 15: each probe kernel against its plain version at the JAX probe
    scripts' shapes, each chain also timed at twice its steps (CHAIN_DOUBLE
    bounds the ratio), then the port's probe scripts with the counts at 0.
    Returns the kernels' stats (at each one's main shape: the chains at 10,000
    steps, the copy at 32768 rows in and out, the mix rounds at 8000, the
    chain fold at 8192 rows and 50,000 steps), the scripts' records and the
    launch counts of their run."""
    import itertools

    import numpy as np
    import torch

    from pim_compression_tpu_torch.ops import hopper_probes as hp
    from pim_compression_tpu_torch.scripts import common, emu_calibrate, hw_probe, transfer_probe, work_ledger

    common.warm(device)
    rng = np.random.default_rng(SEED)

    def int32(rows):
        x = rng.integers(-(2**31), 2**31, (rows, hp.LANES), dtype=np.int64).astype(np.int32)
        return torch.from_numpy(x).to(device)

    stats = {}
    xg, ig = hw_probe.gather_inputs(device)
    xr, ir = int32(128), torch.from_numpy(rng.integers(0, 128, (128, 128)).astype(np.int32)).to(device)
    steps = hw_probe.GATHER_STEPS
    for name, kernel, plain in (("gather_chain", hp.gather_chain, hp.gather_chain_torch),
                                ("ew_chain", hp.ew_chain, hp.ew_chain_torch)):
        compare_probe(f"{name} seeded x{steps}", kernel, plain, (xr, ir, steps), 1)
        st = compare_probe(f"{name} hw_probe inputs x{steps}", kernel, plain, (xg, ig, steps), 5)
        st["bound"] = work_ledger.probe_work(name, xg.shape[0], steps)
        st["steps"] = steps
        # Twice the steps take twice the time, or the steps did not all run.
        st["double_ms"] = common.event_seconds(lambda: kernel(xg, ig, 2 * steps), 5) * 1e3
        ratio = st["double_ms"] / st["ms"]
        log(f"  {name} x{2 * steps}: {st['double_ms']:.4f} ms, {ratio:.3f}x the time at x{steps}")
        if not CHAIN_DOUBLE[0] <= ratio <= CHAIN_DOUBLE[1]:
            raise AssertionError(f"{name}: {2 * steps} steps took {ratio:.3f}x the time of {steps}, "
                                 f"outside {CHAIN_DOUBLE}")
        stats[name] = st
    for in_rows, out_rows in transfer_probe.COPY_ROWS:
        xs = common.cold_copies(int32(in_rows))  # timed from device memory, not L2
        st = compare_probe(f"copy_rows {in_rows} -> {out_rows} rows", hp.copy_rows, hp.copy_rows_torch,
                           (xs[0], out_rows), 20, [(x, out_rows) for x in xs])
        if (in_rows, out_rows) == PROBE_COPY:
            st["bound"] = work_ledger.probe_work("copy_rows", in_rows, out_rows=out_rows)
            # The kernel and the one PyTorch call of the same function, x[:rows]
            # + 1, in turns in one loop on the same cold inputs; each round
            # times 20 queued launches of each.
            turn, kept, rounds = itertools.cycle(xs), [], {"kernel": [], "library": []}
            for _ in range(COPY_ROUNDS):
                for side, fn in (("kernel", lambda: hp.copy_rows(next(turn), out_rows)),
                                 ("library", lambda: next(turn)[:out_rows] + 1)):
                    rounds[side].append(common.event_seconds(lambda: kept.append(fn()), 20) * 1e3)
                    kept.clear()
            st["ms"], st["library_ms"] = (sum(r) / len(r) for r in (rounds["kernel"], rounds["library"]))
            st["rounds_ms"] = rounds
            for side, r in rounds.items():
                log(f"  copy_rows in turns, {side}: mean {sum(r) / len(r):.4f} ms, "
                    f"{min(r):.4f}-{max(r):.4f} over {len(r)} rounds")
            stats["copy_rows"] = st
    for rows, iters in transfer_probe.COMPUTE:
        x = int32(rows)
        st = compare_probe(f"mix_rounds ({rows}, 128) x{iters}", hp.mix_rounds, hp.mix_rounds_torch, (x, iters), 10)
        if iters == PROBE_MIX_ITERS:
            st["bound"] = work_ledger.probe_work("mix_rounds", rows, iters)
            stats["mix_rounds"] = st
    x = int32(8)
    for rows, iterate in emu_calibrate.POINTS:
        if iterate > PROBE_CHAIN[1]:
            continue  # a plain version takes three launches a step: timed only, in emu_calibrate
        st = compare_probe(f"chain_fold {rows} rows x{iterate}", hp.chain_fold, hp.chain_fold_torch,
                           (x, rows, iterate), 3)
        if (rows, iterate) == PROBE_CHAIN:
            st["bound"] = work_ledger.probe_work("chain_fold", rows, iterate)
            stats["chain_fold"] = st
    for name, st in stats.items():
        log(f"  {name}: bound {st['bound']['bound_ms']:.4f} ms ({st['bound']['bound_by']}), "
            f"{st['bound']['bound_ms'] / st['ms']:.2%} of it")

    reset_counts()
    records = {name: mod.run(device) for name, mod in
               (("transfer_probe", transfer_probe), ("hw_probe", hw_probe), ("emu_calibrate", emu_calibrate))}
    counts = dict(hp.LAUNCHES)
    idle = [name for name, n in counts.items() if not n]
    if idle:
        raise AssertionError(f"the probe scripts never launched {idle}: counts {counts}")
    for name, recs in records.items():
        log(f"  {name}: {json.dumps(recs)}")
    log(f"  launches in the scripts' run: {counts}")
    return {"stats": stats, "records": records, "launches": counts}


def probes_summary(probes: dict, card: str) -> dict:
    """The card's measured rates from phase 15's records, beside the
    datasheet's: the device copy at its main shape, the triad, the int32
    rate of the mix rounds at their longest and of the chain fit, the
    dependent steps, and the host copies at the main path's batch sizes."""
    from pim_compression_tpu_torch.scripts import work_ledger

    transfer, hw, emu = (probes["records"][k] for k in ("transfer_probe", "hw_probe", "emu_calibrate"))
    copy_main = next(r for r in transfer if r["kind"] == "copy" and (r["in_mb"], r["out_mb"]) == tuple(
        rows * 512 / 1e6 for rows in PROBE_COPY))
    compute_main = next(r for r in transfer if r["kind"] == "compute" and r["iters"] == PROBE_MIX_ITERS)
    host = {f"{r['kind']} {'pinned' if r['pinned'] else 'pageable'} {r['bytes']} B": r["bytes_per_s"]
            for r in transfer if r["kind"] in ("h2d", "d2h")}
    return {
        "card": card, "device_copy_bytes_per_s": copy_main["kernel_bytes_per_s"],
        "triad_bytes_per_s": next(r for r in hw if r["probe"].startswith("triad"))["achieved_gbps"] * 1e9,
        "datasheet_bytes_per_s": work_ledger.HBM_BYTES_PER_S,
        "int32_ops_per_s": compute_main["int32_ops_per_s"], "int32_ops_per_s_fit": emu["int32_ops_per_s"],
        "int32_lanes_ops_per_s": work_ledger.INT32_LANES_PER_S,
        "int32_issue_limit_ops_per_s": work_ledger.INT32_OPS_PER_S,
        "dependent_round_s": next(r for r in hw if r["probe"].startswith("dependent"))["round_s"],
        "gather_step_s": next(r for r in hw if r["probe"].startswith("gather chain"))["step_s"],
        "elementwise_step_s": next(r for r in hw if r["probe"].startswith("elementwise"))["step_s"],
        "host_copies_bytes_per_s": host,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import numpy as np

    from pim_compression_tpu_torch import TorchCodecConfig, native, runtime
    from pim_compression_tpu_torch.format import oracle
    from pim_compression_tpu_torch.ops import _build, hopper_decode, hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.runtime import devbench, pipeline
    from pim_compression_tpu_torch.utils import streams
    from pim_compression_tpu_torch.utils.config import preset_overrides
    from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

    t_start = time.perf_counter()
    # 1. Device.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)  # name and power limit, as nvidia-smi prints them
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} device(s): {kind}")
    device = torch.device("cuda:0")

    # 2. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
    # The decode kernel's residency: one block a warp, and its shared memory
    # does not depend on the block size or cap, so one query serves every size.
    walks = hopper_decode.walks_per_sm(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    log(f"  decode: {walks} walks per SM at every block size (bs {BS} and {WIDE_BS} alike: its shared memory "
        f"does not depend on block_size or cap), {walks * sms} on {sms} SMs, so a 1024-block batch is "
        f"{-(-1024 // (walks * sms))} wave(s)")
    # The sweep kernel's residency: one CTA a block, its shared memory grows with the block size.
    sweep_ctas = {bs: hopper_sweep.ctas_per_sm(bs, device) for bs in (SWEEP_BS, 16384)}
    log(f"  sweep: {sweep_ctas[SWEEP_BS]} CTAs (blocks) per SM at bs {SWEEP_BS}, {sweep_ctas[16384]} at 16384")

    # 3. Decode kernel against the plain version.
    if not native.available():
        raise RuntimeError("the native host codec is needed to build the payload")
    log("phase 3: decode kernel vs plain PyTorch")
    t0 = time.perf_counter()
    payload = streams.text_payload(MAIN_BLOCKS * BS - 1000, SEED)
    wide_payload = streams.text_payload(MAIN_BLOCKS * WIDE_BS - 1000, SEED)
    log(f"  payloads: {len(payload)} and {len(wide_payload)} bytes in {time.perf_counter() - t0:.2f} s")
    stream = native.compress(payload, BS)
    wide_stream = native.compress(wide_payload, WIDE_BS)
    log(f"  native compress: ratio {len(stream) / len(payload):.4f} at bs {BS}, "
        f"{len(wide_stream) / len(wide_payload):.4f} at bs {WIDE_BS}")
    main_blocks = stream_blocks(stream)

    hand = streams.hand_blocks(BS)
    want = [oracle.decompress(streams.frame_block(p, n, BS)) for p, n in hand]
    stats = [compare("hand-built", to_device(hand, BS, device), BS, want)]
    want = [payload[i * BS : (i + 1) * BS] for i in range(128)]
    stats.append(compare("batch-128", to_device(main_blocks[:128], BS, device), BS, want))
    sub = payload[: 2 << 20]
    for bs in (4096, 24576):
        blocks = stream_blocks(native.compress(sub, bs))
        want = [sub[i * bs : (i + 1) * bs] for i in range(len(blocks))]
        stats.append(compare(f"bs-{bs}", to_device(blocks, bs, device), bs, want))
        if bs == 4096:
            base = streams.hand_blocks(bs) + blocks[:64]
            muts = streams.block_mutants(base, random.Random(SEED), 48, bs)
            stats.append(compare("mutants-4096", to_device(muts, bs, device), bs))
    # Block sizes outside the encoder's envelope, not multiples of 16 (the
    # kernel's byte-wise row writes): 64 blocks of the payload, the
    # hand-built blocks that fit, and mutants (the plain decode takes a few
    # seconds a batch here, most of it at 4097, whose hand-built blocks hold
    # a 4096-byte literal).
    for bs in ODD_SIZES:
        sub = payload[: 64 * bs - bs // 3]
        odd_hand = [blk for blk in streams.hand_blocks(bs) if blk[1] <= bs]
        base = odd_hand + stream_blocks(native.compress(sub, bs))
        want = [oracle.decompress(streams.frame_block(p, n, bs)) for p, n in odd_hand]
        want += [sub[i * bs : (i + 1) * bs] for i in range(len(base) - len(odd_hand))]
        muts = streams.block_mutants(base, random.Random(SEED + bs), 32, bs)
        stats.append(compare(f"bs-{bs}-and-mutants", to_device(base + muts, bs, device), bs, want))
    muts = streams.block_mutants(hand + main_blocks[:16], random.Random(SEED + 1), 48, BS)
    stats.append(compare("mutants-32768", to_device(muts, BS, device), BS))
    # 64 KB: the plain decode's time follows the longest payload, so one
    # batch holds 128 payload blocks, the far-repeat block, the hand-built
    # blocks (a copy at offset 65535) and mutants.
    far = streams.far_repeat_block(WIDE_BS, SEED)
    wide_hand = streams.hand_blocks(WIDE_BS) + stream_blocks(native.compress(far, WIDE_BS))
    wide_blocks = stream_blocks(wide_stream)[:128] + wide_hand
    wide_blocks += streams.block_mutants(wide_blocks, random.Random(SEED + 2), 48, WIDE_BS)
    want = [wide_payload[i * WIDE_BS : (i + 1) * WIDE_BS] for i in range(128)]
    want += [oracle.decompress(streams.frame_block(p, n, WIDE_BS)) for p, n in wide_hand]
    wide_stats = compare("wide-batch-128", to_device(wide_blocks, WIDE_BS, device), WIDE_BS, want)
    stats.append(wide_stats)
    bs = 40960
    sub = wide_payload[: 128 * bs]
    blocks = stream_blocks(native.compress(sub, bs))
    blocks += streams.block_mutants(blocks[:16], random.Random(SEED + 3), 16, bs)
    want = [sub[i * bs : (i + 1) * bs] for i in range(128)]
    stats.append(compare(f"bs-{bs}-and-mutants", to_device(blocks, bs, device), bs, want))

    phase3_plain_ms = sum(st["plain_ms"] for st in stats)
    log(f"  phase 3's plain decodes: {phase3_plain_ms:.1f} ms in all over {len(stats)} batches "
        f"(CUDA graphs of {hopper_decode.GRAPH_STEPS} parse steps)")

    # 4. Decompress main path at 32 KB.
    log(f"phase 4: decompress main path at bs {BS}")
    dec = decompress_main(stream, payload, BS, device, stats[1])
    info = pipeline.scan_frames(stream)

    # 5. Error path.
    log("phase 5: error path")
    cfg = TorchCodecConfig(engine="cuda", block_size=BS)
    bad = bytearray(stream)
    bad[int(info["payload_off"][1])] = 0x01  # block 1 opens with a copy: nothing to copy from
    try:
        runtime.decompress(bytes(bad), cfg)
    except SnappyError as e:
        if "block 1 " not in str(e):
            raise AssertionError(f"corrupt block reported as: {e}") from e
        log(f"  corrupt block rejected: {e}")
    else:
        raise AssertionError("a corrupt block decoded without an error")
    huge = streams.frame_block(hand[0][0], hand[0][1], 163840)
    try:
        runtime.decompress(huge, cfg)
    except SnappyError as e:
        log(f"  declared block size 163840 rejected: {e}")
    else:
        raise AssertionError("a declared block size of 163840 was accepted")

    # 6. Encode kernels against their plain versions at 32 KB and below.
    log("phase 6: match and emit kernels vs plain PyTorch")
    full = np.frombuffer(payload[: (len(payload) // BS) * BS], np.uint8).reshape(-1, BS).copy()
    full_lens = np.full(len(full), BS, np.int32)
    enc_stats = [compare_encode("hand-built", *streams.hand_plain_blocks(BS, SEED), device)]
    enc_stats.append(compare_encode("batch-128", full[:128], full_lens[:128], device))
    sub = payload[: 2 << 20]
    for bs in (4096, 24576):
        blocks, lens = pipeline.blockize_plain(sub, bs)
        enc_stats.append(compare_encode(f"bs-{bs}", blocks, lens, device))
    n = cfg.batch_blocks
    enc_stats.append(compare_encode(f"main-batch-{n}", full[:n], full_lens[:n], device, reps=10))
    enc_batch = enc_stats[-1]

    # 7. Compress main path at 32 KB.
    log(f"phase 7: compress main path at bs {BS}")
    comp = compress_main(payload, BS, enc_batch)

    # 8. Encode error path.
    log("phase 8: encode error path")
    refused = (  # outside the envelope only under strict_engine (phase 18 runs the fallback)
        dict(block_size=WIDE_BS, matcher="sweep", strict_engine=True),
        dict(block_size=16384 + 128, matcher="sweep", strict_engine=True),
        dict(SWEEP_MAIN, block_size=SWEEP_BS + 128), dict(block_size=1000, strict_engine=True),
        dict(sort_window=65536), dict(block_size=24576, sort_window=65536),
    )
    mods = (hopper_decode, hopper_match, hopper_sweep, hopper_encode)
    for knobs in refused:
        reset_counts()
        try:
            runtime.compress(payload[: 1 << 20], TorchCodecConfig(engine="cuda", **knobs))
        except SnappyError as e:
            if e.status != SnappyStatus.BAD_ARGUMENT:
                raise AssertionError(f"{knobs}: refused with {e.status}, not BAD_ARGUMENT") from e
            if any(m.LAUNCHES for m in mods):
                raise AssertionError(f"{knobs}: refused after launching a kernel") from e
            log(f"  {knobs} refused: {e}")
        else:
            raise AssertionError(f"the cuda engine compressed with {knobs}")

    # 9. Encode kernels against their plain versions at 64 KB: the zero-flag
    # config as the runtime runs it above 32 KB, and each preset's 64 KB row
    # (balanced and ratio share theirs).
    log("phase 9: 64 KB match and emit kernels vs plain PyTorch")
    wide_knobs = {
        "zero-flag": TorchCodecConfig(block_size=WIDE_BS),
        **{p: TorchCodecConfig(block_size=WIDE_BS, **preset_overrides(p, WIDE_BS)) for p in ("speed", "balanced")},
    }
    wide_knobs = {name: hopper_encode.encode_knobs(cfg) for name, cfg in wide_knobs.items()}
    wide_full = np.frombuffer(wide_payload[: (len(wide_payload) // WIDE_BS) * WIDE_BS], np.uint8)
    wide_full = wide_full.reshape(-1, WIDE_BS).copy()
    wide_lens = np.full(len(wide_full), WIDE_BS, np.int32)
    for name in ("speed", "balanced"):
        label = "balanced-and-ratio" if name == "balanced" else name
        enc_stats.append(compare_encode(f"{label}-128", wide_full[:128], wide_lens[:128], device, wide_knobs[name]))
    enc_stats.append(compare_encode("zero-flag-far", np.frombuffer(far, np.uint8)[None].copy(),
                                    np.array([WIDE_BS], np.int32), device, wide_knobs["zero-flag"]))
    enc_stats.append(compare_encode(f"zero-flag-main-batch-{n}", wide_full[:n], wide_lens[:n], device,
                                    wide_knobs["zero-flag"], reps=10))
    wide_enc_batch = enc_stats[-1]

    # 10. 64 KB main paths.
    log(f"phase 10: 64 KB main paths at bs {WIDE_BS}")
    wide_comp = compress_main(wide_payload, WIDE_BS, wide_enc_batch)
    if wide_comp["notes"].get("wide_select") != "sel_all sel_cap=16":
        raise AssertionError(f"compress bs {WIDE_BS}: notes {wide_comp['notes']}")
    wide_dec = decompress_main(wide_stream, wide_payload, WIDE_BS, device, wide_stats)

    # 11. The sweep kernel against its plain version.
    log(f"phase 11: sweep kernel vs plain PyTorch at bs {SWEEP_BS} and 16384")
    sweep_payload = payload[: MAIN_BLOCKS * SWEEP_BS - 1000]
    sweep_full = np.frombuffer(sweep_payload[: 1024 * SWEEP_BS], np.uint8).reshape(-1, SWEEP_BS).copy()
    sweep_lens = np.full(len(sweep_full), SWEEP_BS, np.int32)
    big_full = np.frombuffer(payload[: 128 * 16384], np.uint8).reshape(128, 16384).copy()
    # The table walk's hard blocks (one word repeated, zeros, a word at every
    # 8-aligned position, two letters, key collisions) join the edge blocks,
    # the w512 batch and the 16384 batch.
    hard = streams.sweep_hard_blocks(SWEEP_BS, 2048, SEED)
    hard512 = streams.sweep_hard_blocks(SWEEP_BS, 512, SEED + 1)
    hard_big = streams.sweep_hard_blocks(16384, 512, SEED + 2)
    edge = streams.sweep_edge_blocks(SWEEP_BS, 2048, SEED)
    sweep_cases = [
        ("w2048-c8192-sampled", sweep_full[:128], sweep_lens[:128], dict(SWEEP_MAIN, coarse_mode="sampled")),
        ("w2048-c8192-granular", sweep_full[:128], sweep_lens[:128], SWEEP_MAIN),
        ("w512-c4096-granular-and-hard-blocks", np.concatenate([sweep_full[:128], hard512[0]]),
         np.concatenate([sweep_lens[:128], hard512[1]]), dict(SWEEP_MAIN, match_window=512, coarse_window=4096)),
        ("bs-16384-w512-c16384-granular-and-hard-blocks", np.concatenate([big_full, hard_big[0]]),
         np.concatenate([np.full(128, 16384, np.int32), hard_big[1]]),
         dict(SWEEP_MAIN, match_window=512, coarse_window=16384)),
    ]
    for mode in ("sampled", "granular"):
        sweep_cases.append((f"edge-and-hard-blocks-{mode}", np.concatenate([edge[0], hard[0]]),
                            np.concatenate([edge[1], hard[1]]), dict(SWEEP_MAIN, coarse_mode=mode)))
    sweep_stats = []
    for name, blocks, lens, knobs in sweep_cases:
        knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=blocks.shape[1], **knobs))
        sweep_stats.append(compare_encode(name, blocks, lens, device, knobs))
    sweep_knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=SWEEP_BS, **SWEEP_MAIN))
    sweep_stats.append(compare_encode(f"main-batch-{n}", sweep_full, sweep_lens, device, sweep_knobs, reps=10))
    sweep_batch = sweep_stats[-1]

    # 12. The sweep main path.
    log(f"phase 12: sweep compress main path at bs {SWEEP_BS}")
    sweep_comp = compress_main(sweep_payload, SWEEP_BS, sweep_batch, SWEEP_MAIN, payload_raw=True)

    # 13. The sort modes and ladders: the match kernel in its strided,
    # windowed and per-rung-ladder configs against its plain version.
    log("phase 13: sort-mode and ladder kernels vs plain PyTorch")
    mode_stats = {}
    for name, (bs, fields, _) in SORT_MODES.items():
        knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs, **fields))
        rows, rows_lens = (full, full_lens) if bs == BS else (wide_full, wide_lens)
        hb, hl = streams.hand_plain_blocks(bs, SEED)
        blocks, lens = np.concatenate([rows[:128], hb]), np.concatenate([rows_lens[:128], hl])
        mode_stats[name] = compare_encode(f"config-{name}-128-and-hand-built", blocks, lens, device, knobs)
    knobs_a = hopper_encode.encode_knobs(TorchCodecConfig(block_size=BS, **SORT_MODES["a"][1]))
    mode_stats["a-main-batch"] = compare_encode(f"config-a-main-batch-{n}", full[:n], full_lens[:n], device, knobs_a,
                                                reps=10)
    enc_stats += list(mode_stats.values())

    # 14. The CLI at full width, each run in a process of its own.
    log("phase 14: the CLI at full width")
    spliced, wide_spliced = splice(payload, BS), splice(wide_payload, WIDE_BS)
    cfg_a = TorchCodecConfig(engine="torch", device="cuda:0", block_size=BS, **SORT_MODES["a"][1])
    t0 = time.perf_counter()
    stream_a = bytes(runtime.compress(spliced, cfg_a))
    log(f"  config (a) on the torch engine on the GPU: {time.perf_counter() - t0:.1f} s")
    cfg_e = TorchCodecConfig(engine="cuda", block_size=WIDE_BS, **SORT_MODES["e"][1])
    stream_e = bytes(runtime.compress(wide_spliced, cfg_e))
    with tempfile.TemporaryDirectory() as tmp:
        cli_runs = {
            "32768-zero-flag": cli_round_trip("32768-zero-flag", [], spliced, BS, comp["stream"], tmp, comp["batches"]),
            "32768-config-a": cli_round_trip("32768-config-a", SORT_MODES["a"][2], spliced, BS, stream_a, tmp,
                                             comp["batches"]),
            "65536-config-e": cli_round_trip("65536-config-e", SORT_MODES["e"][2], wide_spliced, WIDE_BS, stream_e,
                                             tmp, wide_comp["batches"]),
        }

    # 15. The probes: each kernel against its plain version, then the scripts.
    log("phase 15: probe kernels vs plain PyTorch, and the probe scripts")
    t0 = time.perf_counter()
    probes = probes_phase(device)
    log(f"  phase 15 in {time.perf_counter() - t0:.1f} s")

    # 16. Devbench: the per-wave slope on device-resident batches.
    log(f"phase 16: devbench at bs {BS}")
    reset_counts()
    bench = devbench.slope_measure(payload, TorchCodecConfig(engine="cuda", block_size=BS), iters=5)
    want_ratio = round(1 - enc_batch["ratio"], 4)  # phase 6's main batch is devbench's G=8 batch
    if bench["encode"]["ratio"] != want_ratio:
        raise AssertionError(f"devbench: encode ratio {bench['encode']['ratio']}, phase 6 gives {want_ratio}")
    calls = 2 * (1 + 5)  # G=1 and G=8, a first call and 5 timed each
    launches = (hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES)
    if launches != (calls, calls, calls):
        raise AssertionError(f"devbench: launches (match, emit, decode) {launches}, expected {calls} each")
    log(f"  {json.dumps({'devbench': bench})}")

    # 17. The main paths pipelined at several depths.
    log(f"phase 17: pipelined main paths at bs {BS}, batch_blocks {PIPE_BATCH}, depths {PIPE_DEPTHS}")
    t0 = time.perf_counter()
    piped = pipelined_phase(stream, payload, comp)
    log(f"  phase 17 in {time.perf_counter() - t0:.1f} s")

    # 18. The portable engine.
    log(f"phase 18: the portable engine at bs {BS} and {WIDE_BS} ({card})")
    t0 = time.perf_counter()
    portable = portable_phase(payload, wide_payload, stream, wide_stream, device, card)
    log(f"  phase 18 in {time.perf_counter() - t0:.1f} s")

    # 19. Devices and processes.
    log(f"phase 19: devices and processes at bs {BS} ({card})")
    t0 = time.perf_counter()
    devices = devices_phase(payload, stream, comp, dec, card)
    devices["seconds"] = time.perf_counter() - t0
    log(f"  phase 19 in {devices['seconds']:.1f} s")

    # 20. The tooling.
    log(f"phase 20: the tooling at bs {BS} ({card})")
    t0 = time.perf_counter()
    tools = tooling_phase(payload, comp, cli_runs, card)
    tools["seconds"] = time.perf_counter() - t0
    log(f"  phase 20 in {tools['seconds']:.1f} s")

    # 21. The measurement tools.
    log(f"phase 21: the measurement tools ({card})")
    t0 = time.perf_counter()
    measure = measure_phase(payload, wide_payload, dec, wide_dec, enc_batch, wide_enc_batch, card)
    measure["seconds"]["all"] = time.perf_counter() - t0
    log(f"  phase 21 in {measure['seconds']['all']:.1f} s")
    if measure["seconds"]["all"] > MEASURE_BUDGET_S:
        raise AssertionError(f"phase 21 took {measure['seconds']['all']:.1f} s, over its {MEASURE_BUDGET_S} s")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, max_err, ms, plain_ms, work, **extra):
        return {
            "name": name, "route": "cuda", "source": f"pim_compression_tpu_torch/csrc/{source}",
            "replaces": ", ".join(replaces), "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the codec's functions; the copy's entry sets it
            **extra,
        }

    def probe_entry(name, replaces, shape):
        st = probes["stats"][name]
        extra = {"library_ms": st["library_ms"]} if "library_ms" in st else {}
        if "steps" in st:  # the two chains
            extra["ns_per_step"] = st["ms"] * 1e6 / st["steps"]
        return entry(name, "probes.cu", [replaces], {"phase 15 scripts": probes["launches"][name]},
                     st["max_abs_err"], st["ms"], st["plain_ms"], st["bound"], shape=shape, **extra)

    # Times and bounds: the 64 KB shapes for decode (the 188-block comparison
    # batch), match and emit (one 1024-block batch at the zero-flag config);
    # the sweep's main config for the sweep (one 1024-block batch at 8 KB);
    # the match's sort-mode configs beside (phase 13). Launches: the main
    # paths' runs (phases 4, 7, 10, 12 and 17) and the CLI's (phase 14).
    def cli_launches(kernel):
        return {f"cli {name} {side}": run[side][kernel] for name, run in cli_runs.items()
                for side in ("compress", "decompress") if run[side][kernel]}

    def piped_launches(kernel):
        return {f"{BS} batch {PIPE_BATCH} depth {depth}": rec["launches"][kernel] for depth, rec in piped.items()}

    def devices_launches(kernel):  # phase 19: the split, each rank's process, each dry run
        runs = {f"{BS} split over 2 entries": devices["split"]["launches"][kernel]}
        runs.update({f"{BS} process {r['rank']} of 2": r["launches"][kernel] for r in devices["processes"]["ranks"]})
        runs.update({f"dryrun {n} entries {rec['name']}": rec["launches"][kernel]
                     for n, recs in devices["dryrun"].items() for rec in recs})
        return runs

    def tooling_launches(kernel):  # phase 20: this process's runs and the bench's ranks; phase 21
        return {"phase 20": tools["launches"]["in_process"][kernel] + tools["launches"]["ranks"][kernel],
                "phase 21": measure["launches"][kernel]}

    def timing(st):
        return {"blocks": st["blocks"], "ms": st["match_ms"], "plain_ms": st["match_plain_ms"],
                "bound_ms": st["match_bound"]["bound_ms"], "bound_by": st["match_bound"]["bound_by"],
                "share": st["match_bound"]["bound_ms"] / st["match_ms"]}

    gather_steps = probes["stats"]["gather_chain"]["steps"]
    print(json.dumps({"portable": portable}))
    print(json.dumps({"devices": devices}))
    print(json.dumps({"tooling": tools}))
    print(json.dumps({"measure": measure}))
    print(json.dumps({"probes": probes_summary(probes, card)}))
    print(json.dumps({"kernels": [
        entry(
            "decode_blocks", "decode.cu",
            ["pim_compression_tpu/ops/pallas_decode.py:87", "pim_compression_tpu/ops/pallas_decode.py:263",
             "pim_compression_tpu/ops/pallas_decode.py:620"],
            {str(BS): dec["launches"], str(WIDE_BS): wide_dec["launches"], **cli_launches("decode"),
             **piped_launches("decode"), **devices_launches("decode"), **tooling_launches("decode")},
            max(st["max_abs_err"] for st in stats), wide_stats["ms"], wide_stats["plain_ms"], wide_stats["bound"],
            walks_per_sm=walks, phase3_plain_ms=phase3_plain_ms,
        ),
        entry(
            "match_blocks", "match.cu",
            ["pim_compression_tpu/ops/pallas_match.py:131", "pim_compression_tpu/ops/pallas_match.py:548",
             "pim_compression_tpu/ops/pallas_match.py:679", "pim_compression_tpu/ops/pallas_match.py:821"],
            {str(BS): comp["launches"][0], str(WIDE_BS): wide_comp["launches"][0], **cli_launches("match"),
             **piped_launches("match"), **devices_launches("match"), **tooling_launches("match")},
            max(st["match_err"] for st in enc_stats), wide_enc_batch["match_ms"], wide_enc_batch["match_plain_ms"],
            wide_enc_batch["match_bound"],
            configs={"32768-zero-flag": timing(enc_batch), **{name: timing(st) for name, st in mode_stats.items()}},
        ),
        entry(
            "emit_blocks", "emit.cu",
            ["pim_compression_tpu/ops/pallas_encode.py:559", "pim_compression_tpu/ops/pallas_encode.py:863"],
            {str(BS): comp["launches"][1], str(WIDE_BS): wide_comp["launches"][1],
             str(SWEEP_BS): sweep_comp["launches"][1], **cli_launches("emit"), **piped_launches("emit"),
             **devices_launches("emit"), **tooling_launches("emit")},
            max(st["emit_err"] for st in enc_stats + sweep_stats), wide_enc_batch["emit_ms"],
            wide_enc_batch["emit_plain_ms"], wide_enc_batch["emit_bound"],
        ),
        entry(
            "sweep_blocks", "sweep.cu",
            ["pim_compression_tpu/ops/pallas_encode.py:101", "pim_compression_tpu/ops/pallas_encode.py:175"],
            {str(SWEEP_BS): sweep_comp["launches"][0], "phase 21": measure["launches"]["sweep"]},
            max(st["match_err"] for st in sweep_stats), sweep_batch["match_ms"], sweep_batch["match_plain_ms"],
            sweep_batch["match_bound"], visited_pairs=sweep_batch["visited_pairs"],
            first_word_pairs=sweep_batch["first_word_pairs"],
            visited_bound_ms=sweep_batch["visited_bound"]["bound_ms"], ctas_per_sm=sweep_ctas,
        ),
        probe_entry("gather_chain", "scripts/hw_probe.py:120", f"(128, 128) x {gather_steps}"),
        probe_entry("ew_chain", "scripts/hw_probe.py:159", f"(128, 128) x {gather_steps}"),
        probe_entry("copy_rows", "scripts/transfer_probe.py:40", "{} -> {} rows".format(*PROBE_COPY)),
        probe_entry("mix_rounds", "scripts/transfer_probe.py:44", f"(4096, 128) x {PROBE_MIX_ITERS}"),
        probe_entry("chain_fold", "scripts/emu_calibrate.py:61", "{} rows x {}".format(*PROBE_CHAIN)),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
