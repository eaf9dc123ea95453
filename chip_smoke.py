#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's decompress and compress main paths on one GPU,
at 32 KB and at 64 KB blocks.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: a CUDA device must be present; prints the card and its power limit;
  2. build: compiles the kernels in pim_compression_tpu_torch/csrc with nvcc;
  3. kernel vs plain: the Hopper decode kernel and the plain PyTorch decode
     on the same CUDA tensors (hand-built blocks, a 128-block batch at 32 KB,
     blocks at 4 KB and 24 KB, malformed mutants; at 64 KB 128 blocks of the
     payload with a block whose copies reach past 32768, hand-built blocks and
     mutants in one batch, and blocks at 40 KB): equal verdicts on every
     block, equal bytes on every valid block (exact: the codec is integer-only);
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
  8. encode error path: the sweep matcher above 16384 and granular at a block
     size that is not a multiple of 256, a sort mode, a block size that is not
     a multiple of 128 and the ladder without sel_all are refused with
     BAD_ARGUMENT, and no kernel is launched;
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
     sweep's hand-built edge blocks; a full 1024-block batch of the main
     config): every length and lag equal (exact);
 12. sweep main path: the phase-4 payload cut to 1100 blocks of 8 KB, with 8
     random blocks spliced in, compressed through runtime.compress on the
     "cuda" engine with the sweep (2048/8192, granular), checked as in phase 7
     (the sweep and emit kernels' launch counts equal the batch count, and the
     sorted matcher's stays 0; blocks of the payload's own random stretches
     may be diverted too, each holding over 7.5 bits of entropy a byte).
The line before the last is a JSON summary of the kernels, each with its
time, its plain version's, its launches on the main paths and its bound (the
larger of the bytes it must move over the card's memory rate and the integer
operations its inputs need over the card's integer rate: for the sorted
matcher one table step per position and candidate plus one word compare per
4 bytes of each output length; for the sweep one table step per position
plus the pairs whose first words match, with the exhaustive loop's pairs
beside); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

BS = 32768
WIDE_BS = 65536
SWEEP_BS = 8192
MAIN_BLOCKS = 1100
SEED = 20261016
RANDOM_BLOCKS = (3, 100, 333, 512, 777, 1023, 1024, 1090)  # spliced into the compress payloads
# The sweep's main config: README's best bs-8192 point (-b 8192 --matcher
# sweep --window 2048 --coarse-window 8192 --coarse-mode granular).
SWEEP_MAIN = dict(matcher="sweep", match_window=2048, coarse_window=8192, coarse_mode="granular")

# The card's rates for the bounds (H100 SXM): device memory 3.35 TB/s, and
# int32 issue at 64 lanes per SM per clock on 132 SMs at the 1.98 GHz boost
# clock (the codec's kernels are integer-only; no tensor-core rate applies).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


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
    rate."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "ops": ops,
    }


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep

    hopper_decode.LAUNCHES = hopper_match.LAUNCHES = hopper_sweep.LAUNCHES = hopper_encode.LAUNCHES = 0


def sweep_pairs(blocks, lens, mlen, mlag, window: int, coarse_window: int, granular: bool) -> tuple[int, int]:
    """(visited, first_word): the (position, lag) pairs the exhaustive sweep
    visits on these inputs, and those of them whose first 4-byte words are
    equal, the pairs that a per-block table of word occurrences would still
    have to visit. At every position with 4 bytes left the sweep visits the
    fine lags 1..min(window, p), then the coarse lags (every 8th in (window,
    min(coarse, p)] sampled; every one at 8-aligned positions with 8 bytes
    left, granular), in that order up to the first lag that gives the longest
    bucket the position's remaining length allows (the exact early exit).
    Computed from the inputs and the matcher's output."""
    import torch

    nb, bs = mlen.shape
    p = torch.arange(bs, device=mlen.device, dtype=torch.int64)[None, :].expand(nb, bs)
    room = lens[:, None].long() - p
    maxk = (room >> 2).clamp(0, 16)
    top = torch.zeros_like(maxk)
    for words, length in ((1, 4), (2, 8), (4, 16), (8, 32), (16, 64)):
        top = torch.where(maxk >= words, length, top)
    fine = p.clamp(max=window)
    coarse = coarse_window > window
    reach = (p.clamp(max=coarse_window) - window).clamp(min=0) if coarse else torch.zeros_like(p)
    in_granule = (p % 8 == 0) & (room >= 8)
    if granular:
        step, extra = 1, torch.where(in_granule, reach, 0)
    else:
        step, extra = 8, reach // 8
    lag, length = mlag.long(), mlen.long()
    done = (length > 0) & (length == top)
    stop = torch.where(lag <= window, lag, fine + (lag - window) // step)
    visited = int(torch.where(room >= 4, torch.where(done, stop, fine + extra), 0).sum())

    data = torch.nn.functional.pad(torch.where(room > 0, blocks, 0).long(), (0, 3))
    word = data[:, :bs] | data[:, 1 : bs + 1] << 8 | data[:, 2 : bs + 2] << 16 | data[:, 3 : bs + 3] << 24
    last = torch.where(done, lag, bs)  # the last lag a position visits
    fits = room >= 4
    lags = [(d, fits) for d in range(1, min(window, bs - 1) + 1)]
    if coarse:
        top_lag = min(coarse_window, bs - 1)
        if granular:
            lags += [(d, in_granule) for d in range(window + 1, top_lag + 1)]
        else:
            lags += [(d, fits) for d in range(window + 8, top_lag + 1, 8)]
    first_word = torch.zeros((), dtype=torch.int64, device=mlen.device)
    for d, at in lags:
        first_word += ((word[:, d:] == word[:, :-d]) & at[:, d:] & (last[:, d:] >= d)).sum()
    return visited, int(first_word)


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
    # beside); for the sorted matcher one table step per position and
    # candidate (each rung, and the prev-k steps of the ladder) and one word
    # compare per 4 bytes of each match length; for the emit one parse step
    # per position.
    match_bytes = 4 * nb * bs + 4 * nb
    extra = {}
    if sweep:
        visited, first_word = sweep_pairs(blocks, lens, mlen, mlag, **knobs)
        match_ops = nb * bs + first_word
        extra = {"visited_pairs": visited, "first_word_pairs": first_word,
                 "visited_bound": bound(match_bytes, visited)}
    else:
        steps = len(knobs.get("rungs", (4, 16))) + (knobs.get("prev_k", 1) - 1 if knobs.get("sel_all") else 0)
        match_ops = nb * bs * steps + int(((mlen.long() + 3) >> 2).sum())
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
        "blocks": nb, "bytes": int(lens.sum()), "match_err": err, "emit_err": emit_err,
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
    rng = np.random.default_rng(SEED)
    spliced = bytearray(payload)
    for i in RANDOM_BLOCKS:
        spliced[i * bs : (i + 1) * bs] = rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    spliced = bytes(spliced)
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
    return {"launches": launches, "e2e_gbs": e2e_gbs, "notes": dict(timer.notes), "ratio": len(stream) / len(spliced)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import numpy as np

    from pim_compression_tpu_torch import TorchCodecConfig, native, runtime
    from pim_compression_tpu_torch.format import oracle
    from pim_compression_tpu_torch.ops import _build, hopper_decode, hopper_encode, hopper_match, hopper_sweep
    from pim_compression_tpu_torch.runtime import pipeline
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
    refused = (
        dict(block_size=WIDE_BS, matcher="sweep"), dict(block_size=16384 + 128, matcher="sweep"),
        dict(SWEEP_MAIN, block_size=SWEEP_BS + 128), dict(sort_window=16384), dict(block_size=1000), dict(prev_k=2),
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
    sweep_cases = [
        ("w2048-c8192-sampled", sweep_full[:128], sweep_lens[:128], dict(SWEEP_MAIN, coarse_mode="sampled")),
        ("w2048-c8192-granular", sweep_full[:128], sweep_lens[:128], SWEEP_MAIN),
        ("w512-c4096-granular", sweep_full[:128], sweep_lens[:128], dict(SWEEP_MAIN, match_window=512, coarse_window=4096)),
        ("bs-16384-w512-c16384-granular", big_full, np.full(128, 16384, np.int32),
         dict(SWEEP_MAIN, match_window=512, coarse_window=16384)),
    ]
    for mode in ("sampled", "granular"):
        edge = streams.sweep_edge_blocks(SWEEP_BS, 2048, SEED)
        sweep_cases.append((f"edge-blocks-{mode}", *edge, dict(SWEEP_MAIN, coarse_mode=mode)))
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
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, max_err, ms, plain_ms, work, **extra):
        return {
            "name": name, "route": "cuda", "source": f"pim_compression_tpu_torch/csrc/{source}",
            "replaces": ", ".join(replaces), "launches": sum(launches.values()),
            "launches_by_block_size": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "library_ms": None,  # no single PyTorch call computes any of these functions
            **extra,
        }

    # Times and bounds: the 64 KB shapes for decode (the 188-block comparison
    # batch), match and emit (one 1024-block batch at the zero-flag config);
    # the sweep's main config for the sweep (one 1024-block batch at 8 KB).
    # Launches: the main paths' runs (phases 4, 7, 10 and 12).
    print(json.dumps({"kernels": [
        entry(
            "decode_blocks", "decode.cu",
            ["pim_compression_tpu/ops/pallas_decode.py:87", "pim_compression_tpu/ops/pallas_decode.py:263",
             "pim_compression_tpu/ops/pallas_decode.py:620"],
            {str(BS): dec["launches"], str(WIDE_BS): wide_dec["launches"]},
            max(st["max_abs_err"] for st in stats), wide_stats["ms"], wide_stats["plain_ms"], wide_stats["bound"],
        ),
        entry(
            "match_blocks", "match.cu",
            ["pim_compression_tpu/ops/pallas_match.py:131", "pim_compression_tpu/ops/pallas_match.py:548",
             "pim_compression_tpu/ops/pallas_match.py:679", "pim_compression_tpu/ops/pallas_match.py:821"],
            {str(BS): comp["launches"][0], str(WIDE_BS): wide_comp["launches"][0]},
            max(st["match_err"] for st in enc_stats), wide_enc_batch["match_ms"], wide_enc_batch["match_plain_ms"],
            wide_enc_batch["match_bound"],
        ),
        entry(
            "emit_blocks", "emit.cu",
            ["pim_compression_tpu/ops/pallas_encode.py:559", "pim_compression_tpu/ops/pallas_encode.py:863"],
            {str(BS): comp["launches"][1], str(WIDE_BS): wide_comp["launches"][1],
             str(SWEEP_BS): sweep_comp["launches"][1]},
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
            visited_bound_ms=sweep_batch["visited_bound"]["bound_ms"],
        ),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
