#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's decompress and compress main paths on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: a CUDA device must be present; prints the card and its power limit;
  2. build: compiles the kernels in pim_compression_tpu_torch/csrc with nvcc;
  3. kernel vs plain: the Hopper decode kernel and the plain PyTorch decode
     on the same CUDA tensors (hand-built blocks, a 128-block batch at 32 KB,
     blocks at 4 KB and 24 KB, malformed mutants): equal verdicts on every
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
  8. encode error path: 64 KB blocks, a block size that is not a multiple of
     128 and prev_k=2 are refused with BAD_ARGUMENT.
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
MAIN_BLOCKS = 1100
SEED = 20261016
RANDOM_BLOCKS = (3, 100, 333, 512, 777, 1023, 1024, 1090)  # spliced into the compress payload


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
    return {"blocks": nb, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def compare_encode(name, blocks_np, lens_np, device, reps=5):
    """Match and emit kernels vs their plain versions on the same CUDA
    tensors; returns a stats dict with both kernels' times."""
    import torch

    from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
    from pim_compression_tpu_torch.runtime import pipeline

    nb, bs = blocks_np.shape
    cap = pipeline.padded_capacity(bs)
    blocks = torch.from_numpy(blocks_np).to(device)
    lens = torch.from_numpy(lens_np).to(device)
    mlen, mlag = hopper_match.match_blocks(blocks, lens)
    torch.cuda.synchronize()
    plain = []
    match_plain_ms = cuda_ms(lambda: plain.append(hopper_match.match_blocks_torch(blocks, lens)), 1)
    err = max(
        int((mlen.to(torch.int32) - plain[0][0].to(torch.int32)).abs().max()),
        int((mlag.to(torch.int32) - plain[0][1].to(torch.int32)).abs().max()),
    )
    if err:
        raise AssertionError(f"{name}: match lengths or lags differ (max abs err {err})")
    comp, sizes = hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap)
    torch.cuda.synchronize()
    plain = []
    emit_plain_ms = cuda_ms(lambda: plain.append(hopper_encode.emit_blocks_torch(blocks, lens, mlen, mlag, cap)), 1)
    if not torch.equal(sizes, plain[0][1]):
        raise AssertionError(f"{name}: sizes differ on {int((sizes != plain[0][1]).sum())} blocks")
    emit_err = int((comp.to(torch.int16) - plain[0][0].to(torch.int16)).abs().max())
    if emit_err:
        raise AssertionError(f"{name}: compressed bytes differ (max abs err {emit_err})")
    match_ms = cuda_ms(lambda: hopper_match.match_blocks(blocks, lens), reps)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from pim_compression_tpu import native
    from pim_compression_tpu.format import oracle
    import numpy as np

    from pim_compression_tpu.utils.errors import SnappyError, SnappyStatus
    from pim_compression_tpu_torch import TorchCodecConfig, runtime
    from pim_compression_tpu_torch.ops import _build, hopper_decode, hopper_encode, hopper_match
    from pim_compression_tpu_torch.runtime import pipeline
    from pim_compression_tpu_torch.utils import streams

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

    # 3. Kernel against the plain version.
    if not native.available():
        raise RuntimeError("the native host codec is needed to build the payload")
    log("phase 3: kernel vs plain PyTorch")
    t0 = time.perf_counter()
    payload = streams.text_payload(MAIN_BLOCKS * BS - 1000, SEED)
    log(f"  payload: {len(payload)} bytes in {time.perf_counter() - t0:.2f} s")
    stream = native.compress(payload, BS)
    log(f"  native compress: ratio {len(stream) / len(payload):.4f}")
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

    # 4. Main path at real size.
    log(f"phase 4: main path, {len(main_blocks)} blocks at bs {BS}")
    cfg = TorchCodecConfig(engine="cuda", block_size=BS)
    batches = -(-len(main_blocks) // cfg.batch_blocks)
    timer = runtime.PhaseTimer()
    hopper_decode.LAUNCHES = 0
    t0 = time.perf_counter()
    out = runtime.decompress(stream, cfg, timer)
    e2e_s = time.perf_counter() - t0
    launches = hopper_decode.LAUNCHES
    if bytes(out) != payload:
        raise AssertionError("main path: decompressed bytes differ from the payload")
    if launches != batches:
        raise AssertionError(f"main path: {launches} kernel launches for {batches} batches")
    log(f"  round trip exact; {launches} kernel launches for {batches} batches")
    log(f"  first run: {len(payload) / e2e_s / 1e9:.3f} GB/s end to end; phases {timer.json()}")
    runs = []
    for _ in range(3):
        timer = runtime.PhaseTimer()
        t0 = time.perf_counter()
        out = runtime.decompress(stream, cfg, timer)
        runs.append((time.perf_counter() - t0, timer))
        if bytes(out) != payload:
            raise AssertionError("main path: a repeated run differs from the payload")
    e2e_s, timer = min(runs, key=lambda r: r[0])
    e2e_gbs = len(payload) / e2e_s / 1e9
    log(f"  best of 3: {e2e_gbs:.3f} GB/s end to end ({e2e_s * 1e3:.1f} ms); phases {timer.json()}")

    info = pipeline.scan_frames(stream)
    comp, clen, olen = pipeline.blockize_compressed(stream, info)
    n = cfg.batch_blocks
    args = tuple(torch.from_numpy(a[:n]).to(device) for a in (comp, clen, olen))
    stats.append(compare(f"main-batch-{n}", args, BS, reps=20))
    kernel_ms, plain_ms = stats[-1]["ms"], stats[-1]["plain_ms"]
    batch_bytes = int(olen[:n].sum())
    log(f"  kernel only: {kernel_ms:.3f} ms per {n}-block batch, {batch_bytes / kernel_ms / 1e6:.3f} GB/s")
    log(f"  plain PyTorch: {plain_ms:.1f} ms per batch, {batch_bytes / plain_ms / 1e6:.4f} GB/s")
    t0 = time.perf_counter()
    host = native.decompress(stream, num_threads=1)
    host_s = time.perf_counter() - t0
    if host != payload:
        raise AssertionError("native host decode differs from the payload")
    host_gbs = len(payload) / host_s / 1e9
    log(f"  native host, 1 thread: {host_gbs:.3f} GB/s; end-to-end / host = {e2e_gbs / host_gbs:.3f}")

    # 5. Error path.
    log("phase 5: error path")
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
    try:
        runtime.decompress(native.compress(payload[: 1 << 20], 65536), cfg)
    except SnappyError as e:
        log(f"  64 KB blocks refused by the cuda engine: {e}")
    else:
        raise AssertionError("the cuda engine accepted 64 KB blocks")

    # 6. Encode kernels against their plain versions.
    log("phase 6: match and emit kernels vs plain PyTorch")
    full = np.frombuffer(payload[: (len(payload) // BS) * BS], np.uint8).reshape(-1, BS).copy()
    full_lens = np.full(len(full), BS, np.int32)
    enc_stats = [compare_encode("hand-built", *streams.hand_plain_blocks(BS, SEED), device)]
    enc_stats.append(compare_encode("batch-128", full[:128], full_lens[:128], device))
    for bs in (4096, 24576):
        blocks, lens = pipeline.blockize_plain(sub, bs)
        enc_stats.append(compare_encode(f"bs-{bs}", blocks, lens, device))
    n = TorchCodecConfig().batch_blocks
    enc_stats.append(compare_encode(f"main-batch-{n}", full[:n], full_lens[:n], device, reps=10))
    enc_batch = enc_stats[-1]

    # 7. Compress main path at real size.
    rng = np.random.default_rng(SEED)
    spliced = bytearray(payload)
    for i in RANDOM_BLOCKS:
        spliced[i * BS : (i + 1) * BS] = rng.integers(0, 256, BS, dtype=np.uint8).tobytes()
    spliced = bytes(spliced)
    nblocks = -(-len(spliced) // BS)
    enc_batches = -(-(nblocks - len(RANDOM_BLOCKS)) // cfg.batch_blocks)
    log(f"phase 7: compress main path, {len(spliced)} bytes, {nblocks} blocks at bs {BS}")
    timer = runtime.PhaseTimer()
    hopper_match.LAUNCHES = hopper_encode.LAUNCHES = 0
    t0 = time.perf_counter()
    comp_stream = runtime.compress(spliced, cfg, timer)
    c_first_s = time.perf_counter() - t0
    enc_launches = (hopper_match.LAUNCHES, hopper_encode.LAUNCHES)
    if enc_launches != (enc_batches, enc_batches):
        raise AssertionError(f"compress: launches (match, emit) {enc_launches} for {enc_batches} batches")
    if timer.notes.get("raw_blocks") != len(RANDOM_BLOCKS):
        raise AssertionError(f"compress: {timer.notes.get('raw_blocks')} raw blocks, expected {len(RANDOM_BLOCKS)}")
    log(f"  {enc_launches[0]} match and {enc_launches[1]} emit launches for {enc_batches} batches; "
        f"{timer.notes['raw_blocks']} blocks diverted raw")
    log(f"  first run: {len(spliced) / c_first_s / 1e9:.3f} GB/s end to end; phases {timer.json()}")
    runs = []
    for _ in range(3):
        timer = runtime.PhaseTimer()
        t0 = time.perf_counter()
        again = runtime.compress(spliced, cfg, timer)
        runs.append((time.perf_counter() - t0, timer))
        if bytes(again) != bytes(comp_stream):
            raise AssertionError("compress: a repeated run gave another stream")
    c_e2e_s, timer = min(runs, key=lambda r: r[0])
    c_e2e_gbs = len(spliced) / c_e2e_s / 1e9
    log(f"  best of 3: {c_e2e_gbs:.3f} GB/s end to end ({c_e2e_s * 1e3:.1f} ms); phases {timer.json()}")
    t0 = time.perf_counter()
    plain_stream = runtime.compress(spliced, TorchCodecConfig(engine="torch", device="cuda:0", block_size=BS))
    plain_s = time.perf_counter() - t0
    if bytes(plain_stream) != bytes(comp_stream):
        raise AssertionError("compress: the cuda engine's stream differs from the torch engine's")
    log(f"  equal to the torch engine's stream on the GPU ({plain_s:.1f} s, {len(spliced) / plain_s / 1e9:.4f} GB/s)")
    if bytes(runtime.decompress(bytes(comp_stream), cfg)) != spliced:
        raise AssertionError("compress: the cuda decoder does not give the payload back")
    if native.decompress(bytes(comp_stream)) != spliced:
        raise AssertionError("compress: the native decoder does not give the payload back")
    if bytes(runtime.compress(spliced, TorchCodecConfig(engine="cuda", block_size=BS, verify=True))) != bytes(comp_stream):
        raise AssertionError("compress: verify=True gave another stream")
    log("  decodes back through the cuda engine and native; verify=True passes")
    t0 = time.perf_counter()
    host_stream = native.compress(spliced, BS, num_threads=1)
    host_c_gbs = len(spliced) / (time.perf_counter() - t0) / 1e9
    batch_mb = enc_batch["bytes"] / 1e6
    log(f"  stream ratio {len(comp_stream) / len(spliced):.4f}; native compress ratio {len(host_stream) / len(spliced):.4f}")
    log(f"  kernel only per {n}-block batch: match {enc_batch['match_ms']:.3f} ms + emit {enc_batch['emit_ms']:.3f} ms "
        f"= {batch_mb / (enc_batch['match_ms'] + enc_batch['emit_ms']):.3f} GB/s")
    log(f"  plain PyTorch per batch: match {enc_batch['match_plain_ms']:.1f} ms, emit {enc_batch['emit_plain_ms']:.1f} ms")
    log(f"  native host compress, 1 thread: {host_c_gbs:.3f} GB/s; end-to-end / host = {c_e2e_gbs / host_c_gbs:.3f}")

    # 8. Encode error path.
    log("phase 8: encode error path")
    for knobs in (dict(block_size=65536), dict(block_size=1000), dict(prev_k=2)):
        try:
            runtime.compress(spliced[: 1 << 20], TorchCodecConfig(engine="cuda", **knobs))
        except SnappyError as e:
            if e.status != SnappyStatus.BAD_ARGUMENT:
                raise AssertionError(f"{knobs}: refused with {e.status}, not BAD_ARGUMENT") from e
            log(f"  {knobs} refused: {e}")
        else:
            raise AssertionError(f"the cuda engine compressed with {knobs}")

    print(json.dumps({"kernels": [
        {
            "name": "decode_blocks",
            "route": "cuda",
            "source": "pim_compression_tpu_torch/csrc/decode.cu",
            "replaces": "pim_compression_tpu/ops/pallas_decode.py:87, pim_compression_tpu/ops/pallas_decode.py:263",
            "launches": launches,
            "max_abs_err": max(st["max_abs_err"] for st in stats),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "match_blocks",
            "route": "cuda",
            "source": "pim_compression_tpu_torch/csrc/match.cu",
            "replaces": "pim_compression_tpu/ops/pallas_match.py:131, pim_compression_tpu/ops/pallas_match.py:548",
            "launches": enc_launches[0],
            "max_abs_err": max(st["match_err"] for st in enc_stats),
            "ms": enc_batch["match_ms"],
            "plain_ms": enc_batch["match_plain_ms"],
        },
        {
            "name": "emit_blocks",
            "route": "cuda",
            "source": "pim_compression_tpu_torch/csrc/emit.cu",
            "replaces": "pim_compression_tpu/ops/pallas_encode.py:559",
            "launches": enc_launches[1],
            "max_abs_err": max(st["emit_err"] for st in enc_stats),
            "ms": enc_batch["emit_ms"],
            "plain_ms": enc_batch["emit_plain_ms"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
