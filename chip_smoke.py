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
Phases 4, 7, 10, 12 and 14 run at the default pipeline depth, 2. Phase 18
runs after the launch counts of the other phases are read.
Before the kernels line, a "portable" JSON line gives phase 18's records,
and a "probes" JSON line gives the card's measured
device copy rate and int32 rates beside the datasheet's (the bounds keep the
datasheet's). The line before the last is a JSON summary of the kernels, each with its
time, its plain version's, its launches on the main paths and its bound (the
larger of the bytes it must move over the card's memory rate and the integer
operations its inputs need over the card's integer rate: for the sorted
matcher one table step per sorted row (ceil(bs / stride) of a rung) and
candidate (prev_k on the 4-byte rung in the ladder modes) plus one word
compare per 4 bytes of each output length; for the sweep one table step per position
plus the pairs whose first words match, with the exhaustive loop's pairs
beside; for a probe the steps its inputs take); the last line is
{"ok": true, "device": {...}}.
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

# The card's rates for the bounds (H100 SXM): device memory 3.35 TB/s (the
# datasheet), and int32 operations at the issue limit, one warp instruction
# per scheduler per clock (4 x 32 = 128 lanes per SM) on 132 SMs at the 1.98
# GHz boost clock. The 64 INT32 lanes per SM alone (16.73e12 ops/s) are no
# bound: integer multiplies issue to the FMA pipe beside them, and phase 15's
# mix rounds and elementwise chain run above that rate. The codec's kernels
# are integer-only; no tensor-core rate applies.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_S = 132 * 64 * 1.98e9
INT32_OPS_PER_S = 132 * 128 * 1.98e9


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


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes the function must move (each input read once, each output written
    once) over the memory rate and its integer operations over the int32
    issue limit."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "ops": ops,
    }


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
    # Payload bytes and both lengths read, every output row and verdict
    # written; one operation per plaintext byte.
    work = bound(
        int(args[1].sum()) + 8 * nb + out_k.numel() + err_k.numel() * err_k.element_size(), int(args[2].sum())
    )
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
    # Bytes: blocks and lengths read, lengths and lags written (the emit
    # reads all of them and writes each padded row and size). Operations the
    # function needs: for the sweep one table step per position and the
    # pairs whose first words match (the exhaustive loop's pairs reported
    # beside); for the sorted matcher one table step per sorted row
    # (ceil(bs / stride) of a rung) and candidate (prev_k on the 4-byte rung
    # in the ladder modes) and one word compare per 4 bytes of each match
    # length; for the emit one parse step per position.
    match_bytes = 4 * nb * bs + 4 * nb
    extra = {}
    if sweep:
        visited, first_word = hopper_sweep.sweep_pairs(blocks, lens, mlen, mlag, **knobs)
        match_ops = nb * bs + first_word
        extra = {"visited_pairs": visited, "first_word_pairs": first_word,
                 "visited_bound": bound(match_bytes, visited)}
    else:
        rungs = knobs.get("rungs", (4, 16))
        strides = knobs.get("strides") or (1,) * len(rungs)
        ladder = knobs.get("sel_all") or not knobs.get("rung_pick", True)
        steps = sum(-(-bs // s) * (knobs.get("prev_k", 1) if r == 4 and ladder else 1) for r, s in zip(rungs, strides))
        match_ops = nb * steps + int(((mlen.long() + 3) >> 2).sum())
    match_bound = bound(match_bytes, match_ops)
    emit_bound = bound(nb * (4 * bs + cap) + 8 * nb, int(lens.sum()))
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
    work = bound(int(clen[:n].sum()) + 8 * n + n * bs + 4 * n, batch_bytes)  # as in compare()
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
            "phases": metrics["phases_s"]}


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
    scripts' shapes, then the port's probe scripts with the counts at 0.
    Returns the kernels' stats (at each one's main shape: the chains at 10,000
    steps, the copy at 32768 rows in and out, the mix rounds at 8000, the
    chain fold at 8192 rows and 50,000 steps), the scripts' records and the
    launch counts of their run."""
    import itertools

    import numpy as np
    import torch

    from pim_compression_tpu_torch.ops import hopper_probes as hp
    from pim_compression_tpu_torch.scripts import common, emu_calibrate, hw_probe, transfer_probe

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
        st["bound"] = bound(2 * xg.numel() * 4 + 8 * hp.LANES * 4, 2 * xg.numel() * steps)
        st["steps"] = steps
        stats[name] = st
    for in_rows, out_rows in transfer_probe.COPY_ROWS:
        xs = common.cold_copies(int32(in_rows))  # timed from device memory, not L2
        st = compare_probe(f"copy_rows {in_rows} -> {out_rows} rows", hp.copy_rows, hp.copy_rows_torch,
                           (xs[0], out_rows), 20, [(x, out_rows) for x in xs])
        if (in_rows, out_rows) == PROBE_COPY:
            st["bound"] = bound(transfer_probe.copy_bytes(in_rows, out_rows), 0)
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
            st["bound"] = bound(x.numel() * 4 + 8 * hp.LANES * 4, 3 * iters * x.numel() + x.numel())
            stats["mix_rounds"] = st
    x = int32(8)
    for rows, iterate in emu_calibrate.POINTS:
        if iterate > PROBE_CHAIN[1]:
            continue  # a plain version takes three launches a step: timed only, in emu_calibrate
        st = compare_probe(f"chain_fold {rows} rows x{iterate}", hp.chain_fold, hp.chain_fold_torch,
                           (x, rows, iterate), 3)
        if (rows, iterate) == PROBE_CHAIN:
            lanes = rows * hp.LANES
            st["bound"] = bound(hp.LANES * 4 + 8 * hp.LANES * 4, 3 * iterate * lanes + lanes)
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
    transfer, hw, emu = (probes["records"][k] for k in ("transfer_probe", "hw_probe", "emu_calibrate"))
    copy_main = next(r for r in transfer if r["kind"] == "copy" and (r["in_mb"], r["out_mb"]) == tuple(
        rows * 512 / 1e6 for rows in PROBE_COPY))
    compute_main = next(r for r in transfer if r["kind"] == "compute" and r["iters"] == PROBE_MIX_ITERS)
    host = {f"{r['kind']} {'pinned' if r['pinned'] else 'pageable'} {r['bytes']} B": r["bytes_per_s"]
            for r in transfer if r["kind"] in ("h2d", "d2h")}
    return {
        "card": card, "device_copy_bytes_per_s": copy_main["kernel_bytes_per_s"],
        "triad_bytes_per_s": next(r for r in hw if r["probe"].startswith("triad"))["achieved_gbps"] * 1e9,
        "datasheet_bytes_per_s": HBM_BYTES_PER_S,
        "int32_ops_per_s": compute_main["int32_ops_per_s"], "int32_ops_per_s_fit": emu["int32_ops_per_s"],
        "int32_lanes_ops_per_s": INT32_LANES_PER_S, "int32_issue_limit_ops_per_s": INT32_OPS_PER_S,
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
        return entry(name, "probes.cu", [replaces], {"phase 15 scripts": probes["launches"][name]},
                     st["max_abs_err"], st["ms"], st["plain_ms"], st["bound"], shape=shape,
                     **({"library_ms": st["library_ms"]} if "library_ms" in st else {}))

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

    def timing(st):
        return {"blocks": st["blocks"], "ms": st["match_ms"], "plain_ms": st["match_plain_ms"],
                "bound_ms": st["match_bound"]["bound_ms"], "bound_by": st["match_bound"]["bound_by"],
                "share": st["match_bound"]["bound_ms"] / st["match_ms"]}

    gather_steps = probes["stats"]["gather_chain"]["steps"]
    print(json.dumps({"portable": portable}))
    print(json.dumps({"probes": probes_summary(probes, card)}))
    print(json.dumps({"kernels": [
        entry(
            "decode_blocks", "decode.cu",
            ["pim_compression_tpu/ops/pallas_decode.py:87", "pim_compression_tpu/ops/pallas_decode.py:263",
             "pim_compression_tpu/ops/pallas_decode.py:620"],
            {str(BS): dec["launches"], str(WIDE_BS): wide_dec["launches"], **cli_launches("decode"),
             **piped_launches("decode")},
            max(st["max_abs_err"] for st in stats), wide_stats["ms"], wide_stats["plain_ms"], wide_stats["bound"],
            walks_per_sm=walks,
        ),
        entry(
            "match_blocks", "match.cu",
            ["pim_compression_tpu/ops/pallas_match.py:131", "pim_compression_tpu/ops/pallas_match.py:548",
             "pim_compression_tpu/ops/pallas_match.py:679", "pim_compression_tpu/ops/pallas_match.py:821"],
            {str(BS): comp["launches"][0], str(WIDE_BS): wide_comp["launches"][0], **cli_launches("match"),
             **piped_launches("match")},
            max(st["match_err"] for st in enc_stats), wide_enc_batch["match_ms"], wide_enc_batch["match_plain_ms"],
            wide_enc_batch["match_bound"],
            configs={"32768-zero-flag": timing(enc_batch), **{name: timing(st) for name, st in mode_stats.items()}},
        ),
        entry(
            "emit_blocks", "emit.cu",
            ["pim_compression_tpu/ops/pallas_encode.py:559", "pim_compression_tpu/ops/pallas_encode.py:863"],
            {str(BS): comp["launches"][1], str(WIDE_BS): wide_comp["launches"][1],
             str(SWEEP_BS): sweep_comp["launches"][1], **cli_launches("emit"), **piped_launches("emit")},
            max(st["emit_err"] for st in enc_stats + sweep_stats), wide_enc_batch["emit_ms"],
            wide_enc_batch["emit_plain_ms"], wide_enc_batch["emit_bound"],
        ),
        entry(
            "sweep_blocks", "sweep.cu",
            ["pim_compression_tpu/ops/pallas_encode.py:101", "pim_compression_tpu/ops/pallas_encode.py:175"],
            {str(SWEEP_BS): sweep_comp["launches"][0]},
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
