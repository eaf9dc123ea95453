"""Match finding: the Hopper kernel's wrapper and its plain PyTorch version.

``match_blocks`` is the port of the rung-pick path of
``pim_compression_tpu.ops.pallas_match.sorted_match_groups``. A CUDA tensor
goes to the hand-written kernel in ``csrc/match.cu``, which replaces the TPU
kernels ``_sort_rung_kernel`` and ``_extend_fold_kernel`` and the XLA glue
between them (lag cap, rung pick, neighbor fold). A CPU tensor goes to
``match_blocks_torch``.

``match_blocks_torch`` transcribes the NumPy spec the TPU kernels are held
to (``pim_compression_tpu.ops.lane_model_encode.match_search_sorted`` with
``rung_pick=True``, ``prev_k=1``, stride 1, no sort window): per rung, a
wrapping 32-bit hash ladder over the position's L-byte prefix folded to 17
bits, a sort of ``(key << 15) | pos``, the nearest previous position with
an equal key as the candidate lag, the lag cap, the rung pick (the longest
rung with a candidate wins), one exact extension capped at ``ext_cap``
bytes, and the neighbor fold. The tests and ``chip_smoke.py`` use it; the
``cuda`` engine never calls it.

Both read a block's bytes at or past ``lens[b]`` as zero (the runtime's
blockize zeroes them; the spec sees those zeros).
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.ops import _build

# lane_model_encode.py:183-184: odd 32-bit multipliers of the hash ladder.
HASH_M1 = 0x9E3779B1
HASH_M2 = 0x85EBCA77
_M32 = 0xFFFFFFFF
KEY_BITS = 17  # folded key bits; 15 position bits fill the 32-bit sort word
POS_BITS = 15

RUNGS = (4, 8, 16, 32, 64)
MAX_BLOCK_SIZE = 1 << POS_BITS
MAX_EXT_CAP = 64

# Kernel launches since import (or since a caller reset it). The wrapper
# adds one per launch and nowhere else, so a run can show the kernel ran.
LAUNCHES = 0


def check_knobs(rungs, ext_cap: int, max_lag: int) -> tuple[int, ...]:
    """Validate the matcher's knobs; returns rungs as a tuple."""
    rungs = tuple(int(r) for r in rungs)
    if not rungs or any(r not in RUNGS for r in rungs) or list(rungs) != sorted(set(rungs)):
        raise ValueError(f"rungs must be an ascending subset of {RUNGS}")
    if ext_cap % 4 or not 4 <= ext_cap <= MAX_EXT_CAP:
        raise ValueError(f"ext_cap must be a multiple of 4 in [4, {MAX_EXT_CAP}]")
    if max_lag < 0:
        raise ValueError("max_lag must be >= 0 (0 = whole-block reach)")
    return rungs


def _check_inputs(blocks, lens) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError("blocks must be uint8[num_blocks, block_size]")
    nb, bs = blocks.shape
    if not 0 < bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size must be in (0, {MAX_BLOCK_SIZE}]")
    if lens.dtype != torch.int32 or lens.shape != (nb,):
        raise ValueError(f"lens must be int32[{nb}]")
    if lens.device != blocks.device:
        raise ValueError(f"lens is on {lens.device}, blocks on {blocks.device}")


def _shift_up(x: torch.Tensor, sh: int) -> torch.Tensor:
    """out[:, p] = x[:, p + sh], zero past the end (lane_model_encode._shift_up)."""
    out = torch.zeros_like(x)
    if sh < x.shape[1]:
        out[:, : x.shape[1] - sh] = x[:, sh:]
    return out


def _shift_down(x: torch.Tensor, sh: int) -> torch.Tensor:
    """out[:, p] = x[:, p - sh], zero before the start."""
    out = torch.zeros_like(x)
    if sh < x.shape[1]:
        out[:, sh:] = x[:, : x.shape[1] - sh]
    return out


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2**32 for h in [0, 2**32), exact in int64 (no overflow)."""
    lo = (h & 0xFFFF) * m  # < 2**48
    hi = ((h >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _word4(data: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte words at every position, unsigned, as int64
    (lane_model_encode._pack_word4; bytes past the block read 0)."""
    w = data.clone()
    for b in (1, 2, 3):
        w |= _shift_up(data, b) << (8 * b)
    return w


def _prev_lags(h: torch.Tensor) -> torch.Tensor:
    """Nearest previous position with an equal folded key, as a lag (0 =
    none): lane_model_encode.packed_prev_lags at k = 1, stride 1, no window."""
    nb, bs = h.shape
    key = (h ^ (h >> (32 - KEY_BITS))) & ((1 << KEY_BITS) - 1)  # fold_key
    pos = torch.arange(bs, dtype=torch.int64, device=h.device).expand(nb, bs)
    words = torch.sort((key << POS_BITS) | pos, dim=1).values  # unique, non-negative
    spos = words & ((1 << POS_BITS) - 1)
    skey = words >> POS_BITS
    same = torch.zeros_like(skey, dtype=torch.bool)
    same[:, 1:] = skey[:, 1:] == skey[:, :-1]
    lag_sorted = torch.where(same, spos - _shift_down(spos, 1), 0)
    return torch.zeros_like(lag_sorted).scatter_(1, spos, lag_sorted)


def _extend(w4: torch.Tensor, lens: torch.Tensor, cand: torch.Tensor, max_len: int) -> torch.Tensor:
    """Exact match length (0 or 4..max_len) of each candidate: word rounds
    with a partial-word tail, capped at the block's length
    (lane_model_encode.extend_match with trust=None)."""
    nb, bs = w4.shape
    rows = torch.arange(bs, dtype=torch.int64, device=w4.device).expand(nb, bs)
    has = cand > 0
    idx = rows - cand
    lenacc = torch.zeros_like(cand)
    still = has.clone()
    for k in range(max_len // 4):
        a = _shift_up(w4, 4 * k) if k else w4
        b = torch.gather(w4, 1, (idx + 4 * k).clamp(0, bs - 1))
        x = a ^ b
        weq = still & (x == 0)
        tail = ((x & 0xFF) == 0).long() + ((x & 0xFFFF) == 0).long() + ((x & 0xFFFFFF) == 0).long()
        lenacc += torch.where(weq, 4, torch.where(still, tail, 0))
        still = weq
    lenacc = torch.minimum(lenacc, lens[:, None].long() - rows)
    el = torch.where(has, lenacc.clamp(max=max_len), 0)
    return torch.where(el >= 4, el, 0)


def match_blocks_torch(
    blocks: torch.Tensor, lens: torch.Tensor, *, rungs=(4, 16), ext_cap: int = 48,
    neighbor: bool = True, max_lag: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch match finding for a batch of blocks, on their device.

    blocks uint8[nb, bs] (bs <= 32768), lens int32[nb]. Returns (mlen
    uint8[nb, bs], mlag int16[nb, bs]): the match length (0 or 4..ext_cap)
    and lag at every position; max_lag 0 means no reach cap.
    """
    _check_inputs(blocks, lens)
    rungs = check_knobs(rungs, ext_cap, max_lag)
    nb, bs = blocks.shape
    rows = torch.arange(bs, device=blocks.device)
    data = torch.where(rows[None, :] < lens[:, None], blocks, 0).long()
    w4 = _word4(data)
    sel = torch.zeros((nb, bs), dtype=torch.int64, device=blocks.device)
    h, span = w4, 4
    for length in rungs:
        while span < length:  # _hash_ladder_step: h_2s[p] = h_s[p]*M1 ^ h_s[p+s]*M2
            h = _mul32(h, HASH_M1) ^ _mul32(_shift_up(h, span), HASH_M2)
            span *= 2
        cand = _prev_lags(h)
        if max_lag:
            cand = torch.where(cand <= max_lag, cand, 0)
        sel = torch.where(cand > 0, cand, sel)  # rung pick: the longer rung wins
    best_len = _extend(w4, lens, sel, ext_cap)
    best_off = torch.where(best_len > 0, sel, 0)
    if neighbor:  # derive_neighbor: inherit p-1's match one byte shorter
        ln = _shift_down(best_len, 1) - 1
        take = (ln >= 4) & (ln > best_len)
        best_len = torch.where(take, ln, best_len)
        best_off = torch.where(take, _shift_down(best_off, 1), best_off)
    return best_len.to(torch.uint8), best_off.to(torch.int16)


def match_blocks(
    blocks: torch.Tensor, lens: torch.Tensor, *, rungs=(4, 16), ext_cap: int = 48,
    neighbor: bool = True, max_lag: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match finding for a batch of blocks: the CUDA kernel for CUDA tensors.

    blocks uint8[nb, bs] (contiguous, bs <= 32768) and lens int32[nb] on
    the same device. Returns (mlen uint8[nb, bs], mlag int16[nb, bs]) on
    that device, equal to ``match_blocks_torch``. A CPU tensor is matched by
    ``match_blocks_torch``. The launch goes on the current stream and does
    not synchronise.
    """
    global LAUNCHES
    _check_inputs(blocks, lens)
    knobs = dict(rungs=rungs, ext_cap=ext_cap, neighbor=neighbor, max_lag=max_lag)
    if blocks.device.type == "cpu":
        return match_blocks_torch(blocks, lens, **knobs)
    if blocks.device.type != "cuda":
        raise ValueError(f"match_blocks takes CPU or CUDA tensors, not {blocks.device}")
    if not (blocks.is_contiguous() and lens.is_contiguous()):
        raise ValueError("match_blocks needs contiguous tensors")
    rungs = check_knobs(rungs, ext_cap, max_lag)
    nb, bs = blocks.shape
    mlen = torch.empty((nb, bs), dtype=torch.uint8, device=blocks.device)
    mlag = torch.empty((nb, bs), dtype=torch.int16, device=blocks.device)
    if nb == 0:
        return mlen, mlag
    rung_mask = sum(1 << (r.bit_length() - 3) for r in rungs)  # bit i = rung 4 << i
    lib = _build.load()
    rc = lib.pim_match_blocks(
        blocks.data_ptr(), lens.data_ptr(), mlen.data_ptr(), mlag.data_ptr(),
        nb, bs, rung_mask, ext_cap, int(neighbor), max_lag,
        blocks.device.index if blocks.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"match kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return mlen, mlag
