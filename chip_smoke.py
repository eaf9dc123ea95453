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
  8. encode error path: the sweep matcher, a sort mode, a block size that is
     not a multiple of 128 and the ladder without sel_all are refused with
     BAD_ARGUMENT;
  9. 64 KB kernels vs plain: the match and emit kernels on 128 blocks of the
     64 KB payload at the zero-flag config (switched to the sel_all ladder)
     and at each preset's 64 KB row: every length, lag, size and byte equal;
 10. 64 KB main paths: a ~72 MB payload (1100 blocks of 64 KB) with random
     blocks spliced in compressed through runtime.compress on the "cuda"
     engine (equal to the "torch" engine's stream on the GPU, verify=True,
     decodes back through the "cuda" engine and native; launch counts equal
     the batch counts), and the native codec's 64 KB stream of the payload
     decompressed through the "cuda" engine. Prints end-to-end, kernel-only,
     plain-PyTorch and single-threaded host GB/s and the stream ratio.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

BS = 32768
WIDE_BS = 65536
MAIN_BLOCKS = 1100
SEED = 20261016
RANDOM_BLOCKS = (3, 100, 333, 512, 777, 1023, 1024, 1090)  # spliced into the compress payloads


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
    log(
        f"  {name}: {nb} blocks at bs {block_size}, {int(valid.sum())} valid, "
        f"verdicts equal, max abs err {max_err}; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms"
    )
    return {"blocks": nb, "bytes": int(args[2].sum()), "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def compare_encode(name, blocks_np, lens_np, device, knobs=None, reps=5):
    """Match and emit kernels vs their plain versions on the same CUDA
    tensors, at the given matcher knobs (default: the zero-flag config up to
    32 KB); returns a stats dict with both kernels' times."""
    import torch

    from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
    from pim_compression_tpu_torch.runtime import pipeline

    knobs = knobs or {}
    nb, bs = blocks_np.shape
    cap = pipeline.padded_capacity(bs)
    blocks = torch.from_numpy(blocks_np).to(device)
    lens = torch.from_numpy(lens_np).to(device)
    mlen, mlag = hopper_match.match_blocks(blocks, lens, **knobs)
    torch.cuda.synchronize()
    plain = []
    match_plain_ms = cuda_ms(lambda: plain.append(hopper_match.match_blocks_torch(blocks, lens, **knobs)), 1)
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
    match_ms = cuda_ms(lambda: hopper_match.match_blocks(blocks, lens, **knobs), reps)
    emit_ms = cuda_ms(lambda: hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap), reps)
    ratio = float(sizes.sum()) / max(1, int(lens.sum()))
    log(
        f"  {name}: {nb} blocks at bs {bs}, ratio {ratio:.4f}, lengths, lags, sizes and bytes equal; "
        f"match kernel {match_ms:.4f} ms, plain {match_plain_ms:.1f} ms; "
        f"emit kernel {emit_ms:.4f} ms, plain {emit_plain_ms:.1f} ms"
    )
    return {
        "blocks": nb, "bytes": int(lens.sum()), "match_err": err, "emit_err": emit_err,
        "match_ms": match_ms, "match_plain_ms": match_plain_ms,
        "emit_ms": emit_ms, "emit_plain_ms": emit_plain_ms,
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

    from pim_compression_tpu import native
    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import hopper_decode
    from pim_compression_tpu_torch.runtime import pipeline

    cfg = TorchCodecConfig(engine="cuda", block_size=bs)
    info = pipeline.scan_frames(stream)
    nb = len(info["payload_off"])
    batches = -(-nb // cfg.batch_blocks)
    log(f"  {nb} blocks at bs {bs}, {len(payload)} bytes")
    timer = runtime.PhaseTimer()
    hopper_decode.LAUNCHES = 0
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
    plain_gbs = plain["bytes"] / plain["plain_ms"] / 1e6
    log(f"  kernel only: {kernel_ms:.3f} ms per {n}-block batch, {batch_bytes / kernel_ms / 1e6:.3f} GB/s")
    log(f"  plain PyTorch: {plain['plain_ms']:.1f} ms per {plain['blocks']}-block batch, {plain_gbs:.4f} GB/s")
    t0 = time.perf_counter()
    host = native.decompress(stream, num_threads=1)
    host_gbs = len(payload) / (time.perf_counter() - t0) / 1e9
    if host != payload:
        raise AssertionError("native host decode differs from the payload")
    log(f"  native host, 1 thread: {host_gbs:.3f} GB/s; end-to-end / host = {e2e_gbs / host_gbs:.3f}")
    return {"launches": launches, "kernel_ms": kernel_ms, "e2e_gbs": e2e_gbs}


def compress_main(payload: bytes, bs: int, enc_batch: dict, knobs=None) -> dict:
    """The compress main path at one block size through the "cuda" engine,
    with RANDOM_BLOCKS replaced by seeded random bytes: launch counts, raw
    blocks, best of 3, the "torch" engine's stream on the GPU, round trips,
    verify=True; kernel times from ``enc_batch`` (a compare on one batch)."""
    import numpy as np

    from pim_compression_tpu import native
    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import hopper_encode, hopper_match

    knobs = knobs or {}
    rng = np.random.default_rng(SEED)
    spliced = bytearray(payload)
    for i in RANDOM_BLOCKS:
        spliced[i * bs : (i + 1) * bs] = rng.integers(0, 256, bs, dtype=np.uint8).tobytes()
    spliced = bytes(spliced)
    cfg = TorchCodecConfig(engine="cuda", block_size=bs, **knobs)
    nblocks = -(-len(spliced) // bs)
    batches = -(-(nblocks - len(RANDOM_BLOCKS)) // cfg.batch_blocks)
    log(f"  {len(spliced)} bytes, {nblocks} blocks at bs {bs}, knobs {knobs or 'zero-flag'}")
    timer = runtime.PhaseTimer()
    hopper_match.LAUNCHES = hopper_encode.LAUNCHES = 0
    t0 = time.perf_counter()
    stream = bytes(runtime.compress(spliced, cfg, timer))
    first_s = time.perf_counter() - t0
    launches = (hopper_match.LAUNCHES, hopper_encode.LAUNCHES)
    if launches != (batches, batches):
        raise AssertionError(f"compress bs {bs}: launches (match, emit) {launches} for {batches} batches")
    if timer.notes.get("raw_blocks") != len(RANDOM_BLOCKS):
        raise AssertionError(f"compress bs {bs}: {timer.notes.get('raw_blocks')} raw blocks, expected {len(RANDOM_BLOCKS)}")
    log(f"  {launches[0]} match and {launches[1]} emit launches for {batches} batches; notes {timer.notes}")
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
    log(f"  kernel only per {enc_batch['blocks']}-block batch: match {enc_batch['match_ms']:.3f} ms + emit "
        f"{enc_batch['emit_ms']:.3f} ms = {enc_batch['bytes'] / kernel_ms / 1e6:.3f} GB/s")
    log(f"  plain PyTorch per batch: match {enc_batch['match_plain_ms']:.1f} ms, emit {enc_batch['emit_plain_ms']:.1f} ms")
    log(f"  native host compress, 1 thread: {host_gbs:.3f} GB/s; end-to-end / host = {e2e_gbs / host_gbs:.3f}")
    return {"launches": launches, "e2e_gbs": e2e_gbs, "notes": dict(timer.notes)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from pim_compression_tpu import native
    from pim_compression_tpu.format import oracle
    import numpy as np

    from pim_compression_tpu.utils.config import preset_overrides
    from pim_compression_tpu.utils.errors import SnappyError, SnappyStatus
    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import _build, hopper_encode
    from pim_compression_tpu_torch.runtime import pipeline
    from pim_compression_tpu_torch.utils import streams

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
        dict(block_size=WIDE_BS, matcher="sweep"), dict(sort_window=16384), dict(block_size=1000), dict(prev_k=2),
    )
    for knobs in refused:
        try:
            runtime.compress(payload[: 1 << 20], TorchCodecConfig(engine="cuda", **knobs))
        except SnappyError as e:
            if e.status != SnappyStatus.BAD_ARGUMENT:
                raise AssertionError(f"{knobs}: refused with {e.status}, not BAD_ARGUMENT") from e
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
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, max_err, ms, plain_ms):
        return {
            "name": name, "route": "cuda", "source": f"pim_compression_tpu_torch/csrc/{source}",
            "replaces": ", ".join(replaces), "launches": sum(launches.values()),
            "launches_by_block_size": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        }

    # Times: the 64 KB shapes (decode: the 128-block comparison batch; match
    # and emit: one 1024-block batch at the zero-flag config).
    print(json.dumps({"kernels": [
        entry(
            "decode_blocks", "decode.cu",
            ["pim_compression_tpu/ops/pallas_decode.py:87", "pim_compression_tpu/ops/pallas_decode.py:263",
             "pim_compression_tpu/ops/pallas_decode.py:620"],
            {str(BS): dec["launches"], str(WIDE_BS): wide_dec["launches"]},
            max(st["max_abs_err"] for st in stats), wide_stats["ms"], wide_stats["plain_ms"],
        ),
        entry(
            "match_blocks", "match.cu",
            ["pim_compression_tpu/ops/pallas_match.py:131", "pim_compression_tpu/ops/pallas_match.py:548",
             "pim_compression_tpu/ops/pallas_match.py:679", "pim_compression_tpu/ops/pallas_match.py:821"],
            {str(BS): comp["launches"][0], str(WIDE_BS): wide_comp["launches"][0]},
            max(st["match_err"] for st in enc_stats), wide_enc_batch["match_ms"], wide_enc_batch["match_plain_ms"],
        ),
        entry(
            "emit_blocks", "emit.cu",
            ["pim_compression_tpu/ops/pallas_encode.py:559", "pim_compression_tpu/ops/pallas_encode.py:863"],
            {str(BS): comp["launches"][1], str(WIDE_BS): wide_comp["launches"][1]},
            max(st["emit_err"] for st in enc_stats), wide_enc_batch["emit_ms"], wide_enc_batch["emit_plain_ms"],
        ),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
