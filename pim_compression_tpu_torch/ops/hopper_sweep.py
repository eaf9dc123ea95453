"""The sweep matcher: the Hopper kernel's wrapper and its plain PyTorch version.

``sweep_match`` is the port of the sweep path of ``pim_compression_tpu.ops.
pallas_encode.encode_blocks_pallas`` (``matcher="sweep"``, block sizes up to
16384). A CUDA tensor goes to the hand-written kernel in ``csrc/sweep.cu``,
which replaces the TPU kernels ``_match_kernel`` (the fine sweep and the
sampled coarse sweep) and ``_granule_kernel`` (the phased-granule coarse
search) and the XLA glue around them (the padded and valid planes,
``_granule_planes``, the upsample and the merge). A CPU tensor goes to
``sweep_match_torch``.

``sweep_match_torch`` transcribes the NumPy spec the TPU kernels are held to
(``pim_compression_tpu.ops.lane_model_encode``): ``match_search`` (every lag
in [1, window], and in sampled mode every 8th lag in (window, coarse]) and,
in granular mode, ``match_search_granular`` (the fine sweep, then
``granule_search`` over every lag in (window, coarse] at 8-byte-aligned
positions, merged by the packed max). A candidate's length is its exact
byte run at the lag, cut at the block's length and bucketed to the largest
of {4, 8, 16, 32, 64} it reaches ({8, ..., 64} for a granule); the fold
keeps ``(length << 16) | (0xFFFF - lag)`` at its maximum: longest first,
then nearest. The tests and ``chip_smoke.py`` use it; the ``cuda`` engine
never calls it.

Both take the knobs as given, as the spec does: ``sweep_knobs`` is the one
place that normalises them, and ``hopper_encode.encode_knobs`` calls it once
per config. Both read a block's bytes at or past ``lens[b]`` as zero. Lags
stay below 16384, so ``mlag`` holds them as plain int16.
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.ops import _build
from pim_compression_tpu_torch.ops.hopper_match import _check_inputs, _shift_down, _shift_up

# pallas_encode.py:47: the sweep's block-size envelope.
MAX_SWEEP_BLOCK = 16384
COARSE_STEP = 8  # the sampled coarse sweep's lag stride (lane_model_encode.match_search)
COARSE_CHUNK = 256  # the sampled range is whole 32-lag chunks of stride 8 (pallas_encode.py:1239)
GRANULE = 8
BUCKETS = (64, 32, 16, 8, 4)

# Kernel launches since import (or since a caller reset it). The wrapper
# adds one per launch and nowhere else, so a run can show the kernel ran.
LAUNCHES = 0


def sweep_knobs(block_size: int, window: int, coarse_window: int = 0, granular: bool = False) -> dict:
    """The sweep's knobs as ``encode_blocks_pallas`` normalises them
    (``pallas_encode.py:1228-1244``): the window is cut to the block and
    rounded up to 32; the coarse reach is cut to the block; sampled mode
    rounds the coarse range down to whole 256-lag chunks; a coarse reach at
    or below the window means no coarse search (0). Raises ``ValueError``
    above 16384, for a negative knob, and for granular coarse search at a
    block size that is not a multiple of 256.
    """
    if not 0 < block_size <= MAX_SWEEP_BLOCK:
        raise ValueError(f"the sweep matcher takes block sizes in (0, {MAX_SWEEP_BLOCK}]")
    if window < 0 or coarse_window < 0:
        raise ValueError("match_window and coarse_window must be >= 0")
    window = (min(window, block_size) + 31) // 32 * 32
    coarse = min(coarse_window, block_size)
    if granular and coarse > window and block_size % 256:
        raise ValueError("granular coarse matching needs block_size % 256 == 0")
    if not granular and coarse > window:
        coarse = window + (coarse - window) // COARSE_CHUNK * COARSE_CHUNK
    if coarse <= window:
        coarse = 0
    return dict(window=window, coarse_window=coarse, granular=bool(granular))


def _check(blocks: torch.Tensor, lens: torch.Tensor, window: int, coarse_window: int) -> None:
    _check_inputs(blocks, lens)
    if blocks.shape[1] > MAX_SWEEP_BLOCK:
        raise ValueError(f"the sweep matcher takes block sizes in (0, {MAX_SWEEP_BLOCK}]")
    if window < 0 or coarse_window < 0:
        raise ValueError("window and coarse_window must be >= 0")


def _fine_score(data, valid, rows, d: int, score: torch.Tensor) -> torch.Tensor:
    """One lag of lane_model_encode.match_search's ``sweep``: shifted
    equality, AND-doubling to run[L], the bucket, the packed max."""
    eq = (data == _shift_down(data, d)) & valid & (rows >= d)
    run = {1: eq}
    for length in (2, 4, 8, 16, 32, 64):
        run[length] = run[length // 2] & _shift_up(run[length // 2], length // 2)
    ml = torch.zeros_like(score)
    for length in BUCKETS:
        ml = torch.where((ml == 0) & run[length], length, ml)
    cand = torch.where(ml >= 4, (ml << 16) | (0xFFFF - d), 0)
    return torch.maximum(score, cand)


def _granule_score(data, lens, window: int, coarse: int) -> torch.Tensor:
    """lane_model_encode.granule_search: 8-byte granules of exact 4-byte
    words at 8 phases, every lag in (window, coarse], granule AND-doubling
    to byte buckets {8, 16, 32, 64}; packed scores at granule-aligned rows."""
    nb, bs = data.shape
    ng = bs // GRANULE
    score = torch.zeros((nb, bs), dtype=torch.int32, device=data.device)
    if ng == 0 or coarse <= window:
        return score
    w4 = torch.zeros((nb, bs), dtype=torch.int64, device=data.device)
    for b in range(4):
        w4 += (data if b == 0 else _shift_up(data, b)).long() << (8 * b)
    rows = torch.arange(bs, device=data.device)
    tail_ok = rows[None, :] + 8 <= lens[:, None]
    grow = torch.arange(ng, device=data.device)[None, :] * 8
    g_scores = torch.zeros((nb, ng), dtype=torch.int32, device=data.device)
    lo0, hi0 = w4[:, 0::8][:, :ng], w4[:, 4::8][:, :ng]
    ok0 = tail_ok[:, 0::8][:, :ng]
    for r in range(8):
        lo_r = torch.zeros((nb, ng), dtype=torch.int64, device=data.device)
        hi_r = torch.zeros_like(lo_r)
        nr = (bs - r - 4) // 8 + 1 if bs - r >= 4 else 0
        lo_r[:, :nr] = w4[:, r::8][:, :nr]
        nr2 = (bs - r - 8) // 8 + 1 if bs - r >= 8 else 0
        hi_r[:, :nr2] = w4[:, r + 4 :: 8][:, :nr2]
        d_lo = (window + 1 + r + 7) // 8
        d_hi = (coarse + r) // 8
        for big_d in range(max(d_lo, 1), d_hi + 1):
            d = 8 * big_d - r
            eq = (lo0 == _shift_down(lo_r, big_d)) & (hi0 == _shift_down(hi_r, big_d)) & ok0 & (grow >= d)
            run = {1: eq}
            for g in (2, 4, 8):
                run[g] = run[g // 2] & _shift_up(run[g // 2], g // 2)
            gl = torch.zeros_like(g_scores)
            for g in (8, 4, 2, 1):
                gl = torch.where((gl == 0) & run[g], 8 * g, gl)
            cand = torch.where(gl >= 8, (gl << 16) | (0xFFFF - d), 0)
            g_scores = torch.maximum(g_scores, cand)
    score[:, : ng * GRANULE : GRANULE] = g_scores
    return score


def sweep_match_torch(
    blocks: torch.Tensor, lens: torch.Tensor, *, window: int = 512, coarse_window: int = 0,
    granular: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch sweep matcher for a batch of blocks, on their device.

    blocks uint8[nb, bs] (bs <= 16384), lens int32[nb]; the knobs as
    ``sweep_knobs`` returns them (not normalised again here). Returns (mlen
    uint8[nb, bs], mlag int16[nb, bs]): the bucketed length (0 or 4..64) and
    the lag at every position, 0 where nothing matched.
    """
    _check(blocks, lens, window, coarse_window)
    nb, bs = blocks.shape
    coarse = coarse_window
    rows = torch.arange(bs, device=blocks.device)[None, :]
    valid = rows < lens[:, None]
    data = torch.where(valid, blocks, 0).to(torch.int32)
    score = torch.zeros((nb, bs), dtype=torch.int32, device=blocks.device)
    for d in range(1, min(window, bs - 1) + 1):
        score = _fine_score(data, valid, rows, d, score)
    if not granular:
        for d in range(window + COARSE_STEP, min(coarse, bs - 1) + 1, COARSE_STEP):
            score = _fine_score(data, valid, rows, d, score)
    else:
        score = torch.maximum(score, _granule_score(data, lens, window, coarse))
    mlen = score >> 16
    mlag = torch.where(mlen > 0, 0xFFFF - (score & 0xFFFF), 0)
    return mlen.to(torch.uint8), mlag.to(torch.int16)


def sweep_match(
    blocks: torch.Tensor, lens: torch.Tensor, *, window: int = 512, coarse_window: int = 0,
    granular: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sweep matching for a batch of blocks: the CUDA kernel for CUDA tensors.

    Arguments and result as ``sweep_match_torch`` (blocks and lens
    contiguous, on one device), equal to it on every position. A CPU tensor
    is matched by ``sweep_match_torch``. The launch goes on the current
    stream and does not synchronise.
    """
    global LAUNCHES
    _check(blocks, lens, window, coarse_window)
    if blocks.device.type == "cpu":
        return sweep_match_torch(blocks, lens, window=window, coarse_window=coarse_window, granular=granular)
    if blocks.device.type != "cuda":
        raise ValueError(f"sweep_match takes CPU or CUDA tensors, not {blocks.device}")
    if not (blocks.is_contiguous() and lens.is_contiguous()):
        raise ValueError("sweep_match needs contiguous tensors")
    nb, bs = blocks.shape
    dev = blocks.device
    mlen = torch.empty((nb, bs), dtype=torch.uint8, device=dev)
    mlag = torch.empty((nb, bs), dtype=torch.int16, device=dev)
    if nb == 0:
        return mlen, mlag
    lib = _build.load()
    rc = lib.pim_sweep_blocks(
        blocks.data_ptr(), lens.data_ptr(), mlen.data_ptr(), mlag.data_ptr(),
        nb, bs, window, coarse_window, int(granular),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return mlen, mlag
