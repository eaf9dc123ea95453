"""Device-resident codec throughput: the time per wave of blocks on the card.

The counterpart of ``pim_compression_tpu.runtime.devbench``. It times the
encode (match + emit) and the decode of one batch of blocks with every
input already on the device, at G=1 (128 blocks) and G=8 (1024 blocks),
and takes the slope ``(t_G8 - t_G1) / 7``: seconds per 128 blocks with the
launch overhead cancelled. On an H100 the kernels run one CTA per block, so
128 blocks are about one wave on the 132 SMs and 1024 are eight: the slope
is the time per wave. The reference needed the slope to cancel a TPU's
dispatch floor; here it also keeps the host's copies out of the number, as
the end-to-end GB/s of ``runtime.compress`` / ``decompress`` do not.

The ``cuda`` engine times the kernels by CUDA events; the ``torch`` engine
times the plain PyTorch versions on ``config.device`` (CUDA events on a
GPU, the host clock on the CPU, and then the numbers are the CPU's, not the
card's). The result names the device it ran on.
"""

from __future__ import annotations

import time

import torch

from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode
from pim_compression_tpu_torch.parallel import resolve_device
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

LANES = 128
GROUPS = 8


def _timed(fn, args, iters: int, on_cuda: bool):
    """(best seconds of iters calls, seconds of the first call, the last
    call's output). The first call also loads the kernels."""

    def once():
        if on_cuda:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3, out
        t0 = time.perf_counter()
        out = fn(*args)
        return time.perf_counter() - t0, out

    t0 = time.perf_counter()
    _, out = once()
    first_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(iters):
        secs, out = once()
        best = min(best, secs)
    return best, first_s, out


def _slope(t1: float, t8: float, bs: int) -> dict:
    per = (t8 - t1) / (GROUPS - 1)
    return {
        "t_g1_s": t1, "t_g8_s": t8, "per_group_s": per,
        # None where noise makes the slope vanish: no rate follows from it.
        "device_gbps": bs * LANES / per / 1e9 if per > 0 else None,
    }


def slope_measure(plain: bytes, cfg, iters: int = 5) -> dict:
    """Encode and decode GB/s per wave for ``cfg`` (a ``TorchCodecConfig``
    with the ``cuda`` or ``torch`` engine) on ``plain`` repeated or cut to
    1024 blocks of ``cfg.block_size``.

    Returns ``bs``, ``device`` (the card's name, or "cpu"), and per
    direction ``t_g1_s``, ``t_g8_s``, ``per_group_s``, ``device_gbps`` and
    ``compile_s`` (the first calls of both sizes, kernel load included), as
    the reference's keys; the encode also gives ``ratio`` on the G=8 batch,
    ``1 - compressed / plaintext bytes`` to 4 places as the reference
    computes it. Times are unrounded. Raises ``SnappyError(BAD_ARGUMENT)``
    for another engine or a config outside the encoder's envelope, and
    ``RuntimeError`` if a decoded block carries an error bit.
    """
    if cfg.engine not in ("cuda", "torch"):
        raise SnappyError(SnappyStatus.BAD_ARGUMENT, f"slope_measure times the cuda or torch engine, not {cfg.engine!r}")
    if not plain:
        raise ValueError("slope_measure needs plaintext")
    knobs = hopper_encode.encode_knobs(cfg)
    device = resolve_device(cfg.engine, cfg.device)
    on_cuda = device.type == "cuda"
    if cfg.engine == "cuda":
        encode, decode = hopper_encode.encode_blocks, hopper_decode.decode_blocks
    else:
        encode, decode = hopper_encode.encode_blocks_torch, hopper_decode.decode_blocks_torch

    bs = cfg.block_size
    nb = GROUPS * LANES
    need = bs * nb
    if len(plain) < need:
        plain = plain * -(-need // len(plain))
    plain = plain[:need]
    blocks, lens = pipeline.blockize_plain(plain, bs)
    stream = native.compress(plain, block_size=bs)
    comp, comp_len, out_len = pipeline.blockize_compressed(stream, pipeline.scan_frames(stream))
    cap = pipeline.padded_capacity(bs)

    def enc_fn(b, n):
        out, sizes = encode(b, n, cap=cap, **knobs)
        return out.sum(dtype=torch.int64), sizes

    def dec_fn(c, cl, ol):
        out, err = decode(c, cl, ol, block_size=bs)
        return out.sum(dtype=torch.int64), err

    def put(*arrays, rows):
        return tuple(torch.from_numpy(a[:rows]).to(device) for a in arrays)

    res: dict = {"bs": bs, "device": torch.cuda.get_device_name(device) if on_cuda else device.type}
    t1, c1, _ = _timed(enc_fn, put(blocks, lens, rows=LANES), iters, on_cuda)
    t8, c8, (_, sizes) = _timed(enc_fn, put(blocks, lens, rows=nb), iters, on_cuda)
    res["encode"] = {
        **_slope(t1, t8, bs), "ratio": round(1.0 - float(sizes.sum()) / need, 4), "compile_s": c1 + c8,
    }
    t1, c1, _ = _timed(dec_fn, put(comp, comp_len, out_len, rows=LANES), iters, on_cuda)
    t8, c8, (_, err) = _timed(dec_fn, put(comp, comp_len, out_len, rows=nb), iters, on_cuda)
    if int((err != 0).sum()):
        raise RuntimeError("the device decode flagged errors during the measurement")
    res["decode"] = {**_slope(t1, t8, bs), "compile_s": c1 + c8}
    return res
