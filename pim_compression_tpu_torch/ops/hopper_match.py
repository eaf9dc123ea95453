"""Match finding: the Hopper kernel's wrapper and its plain PyTorch version.

``match_blocks`` is the port of ``pim_compression_tpu.ops.pallas_match.
sorted_match_groups`` on its rung-pick path and on its ``sel_all``
select-then-extend path, at block sizes up to 65536. A CUDA tensor goes to
the hand-written kernel in ``csrc/match.cu``, which replaces the TPU kernels
``_sort_rung_kernel``, ``_extend_fold_kernel``, ``_select_extend_kernel``
and ``_prev_step_kernel`` and the XLA glue between them (lag cap, rung
pick, neighbor fold). A CPU tensor goes to ``match_blocks_torch``.

``match_blocks_torch`` transcribes the NumPy spec the TPU kernels are held
to (``pim_compression_tpu.ops.lane_model_encode.match_search_sorted`` with
``rung_pick=True``, or with ``sel_all=True`` and ``sel_cap``; stride 1, no
sort window): per rung, a wrapping 32-bit hash ladder over the position's
L-byte prefix folded to 17 bits (16 above 32768 positions), a sort of
``(key << pos_bits) | pos``, the j-th previous position with an equal key
as a candidate lag (j up to ``prev_k`` on the 4-byte rung, 1 elsewhere),
the lag cap, then either the rung pick (the longest rung with a candidate
wins) or the capped select (each candidate array in order gets an extension
capped at ``sel_cap`` bytes; the strictly longest wins), one exact
extension of the winner capped at ``ext_cap`` bytes, and the neighbor fold.
The tests and ``chip_smoke.py`` use it; the ``cuda`` engine never calls it.

Both read a block's bytes at or past ``lens[b]`` as zero (the runtime's
blockize zeroes them; the spec sees those zeros). Lags reach 65535, so
``mlag`` holds the int16 bit pattern of a lag: read it unsigned
(``mlag.long() & 0xFFFF``), as the TPU's wide emit does.
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.ops import _build

# lane_model_encode.py:183-184: odd 32-bit multipliers of the hash ladder.
HASH_M1 = 0x9E3779B1
HASH_M2 = 0x85EBCA77
_M32 = 0xFFFFFFFF

RUNGS = (4, 8, 16, 32, 64)
MAX_BLOCK_SIZE = 65536
MAX_EXT_CAP = 64
MAX_PREV_K = 8
HALF = 32768  # positions the kernel sorts at once in shared memory

# Kernel launches since import (or since a caller reset it). The wrapper
# adds one per launch and nowhere else, so a run can show the kernel ran.
LAUNCHES = 0


def pos_bits(block_size: int) -> int:
    """Position bits of a sort word: 15 up to 32768 positions, 16 above
    (lane_model_encode.packed_prev_lags); the folded key takes the rest."""
    return 15 if block_size <= HALF else 16


def check_knobs(
    rungs, ext_cap: int, max_lag: int, prev_k: int = 1, sel_cap: int = 0, sel_all: bool = False
) -> tuple[int, ...]:
    """Validate the matcher's knobs; returns rungs as a tuple."""
    rungs = tuple(int(r) for r in rungs)
    if not rungs or any(r not in RUNGS for r in rungs) or list(rungs) != sorted(set(rungs)):
        raise ValueError(f"rungs must be an ascending subset of {RUNGS}")
    if ext_cap % 4 or not 4 <= ext_cap <= MAX_EXT_CAP:
        raise ValueError(f"ext_cap must be a multiple of 4 in [4, {MAX_EXT_CAP}]")
    if max_lag < 0:
        raise ValueError("max_lag must be >= 0 (0 = whole-block reach)")
    if sel_all:
        if sel_cap % 4 or not 4 <= sel_cap <= ext_cap:
            raise ValueError("sel_all needs sel_cap, a multiple of 4 in [4, ext_cap]")
        if not 1 <= prev_k <= MAX_PREV_K:
            raise ValueError(f"prev_k must be in [1, {MAX_PREV_K}]")
    elif prev_k != 1 or sel_cap:
        raise ValueError(
            "prev_k > 1 and sel_cap without sel_all (the non-sel_all ladder) "
            "are not ported yet (ROADMAP A item 7)"
        )
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


def _as_int16(lag: torch.Tensor) -> torch.Tensor:
    """Lags in [0, 65535] as the int16 tensor holding their bit pattern."""
    return torch.where(lag >= 32768, lag - 65536, lag).to(torch.int16)


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


def _prev_lags(h: torch.Tensor, prev_k: int) -> list[torch.Tensor]:
    """The j-th previous position with an equal folded key, as a lag (0 =
    none), for j = 1..prev_k: lane_model_encode.packed_prev_lags at stride
    1, no window."""
    nb, bs = h.shape
    pb = pos_bits(bs)
    key = (h ^ (h >> pb)) & ((1 << (32 - pb)) - 1)  # fold_key(h, 32 - pb)
    pos = torch.arange(bs, dtype=torch.int64, device=h.device).expand(nb, bs)
    words = torch.sort((key << pb) | pos, dim=1).values  # unique, non-negative
    spos = words & ((1 << pb) - 1)
    skey = words >> pb
    out = []
    for j in range(1, prev_k + 1):
        same = torch.zeros_like(skey, dtype=torch.bool)
        same[:, j:] = skey[:, j:] == skey[:, :-j]
        lag_sorted = torch.where(same, spos - _shift_down(spos, j), 0)
        out.append(torch.zeros_like(lag_sorted).scatter_(1, spos, lag_sorted))
    return out


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
    neighbor: bool = True, max_lag: int = 8192, prev_k: int = 1, sel_cap: int = 0,
    sel_all: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch match finding for a batch of blocks, on their device.

    blocks uint8[nb, bs] (bs <= 65536), lens int32[nb]. Returns (mlen
    uint8[nb, bs], mlag int16[nb, bs]): the match length (0 or 4..ext_cap)
    and the lag's bit pattern at every position; max_lag 0 means no reach
    cap. ``sel_all`` (with ``sel_cap`` and any ``prev_k``) runs the select
    ladder, otherwise the rung pick (``prev_k=1``, ``sel_cap=0``).
    """
    _check_inputs(blocks, lens)
    rungs = check_knobs(rungs, ext_cap, max_lag, prev_k, sel_cap, sel_all)
    nb, bs = blocks.shape
    rows = torch.arange(bs, device=blocks.device)
    data = torch.where(rows[None, :] < lens[:, None], blocks, 0).long()
    w4 = _word4(data)
    zero = torch.zeros((nb, bs), dtype=torch.int64, device=blocks.device)
    sel, sel_len = zero, zero
    h, span = w4, 4
    for length in rungs:
        while span < length:  # _hash_ladder_step: h_2s[p] = h_s[p]*M1 ^ h_s[p+s]*M2
            h = _mul32(h, HASH_M1) ^ _mul32(_shift_up(h, span), HASH_M2)
            span *= 2
        for cand in _prev_lags(h, prev_k if length == 4 else 1):
            if max_lag:
                cand = torch.where(cand <= max_lag, cand, 0)
            if not sel_all:  # rung pick: the longer rung wins
                sel = torch.where(cand > 0, cand, sel)
                continue
            cl = _extend(w4, lens, cand, sel_cap)  # capped select, earlier arrays win ties
            better = cl > sel_len
            sel_len = torch.where(better, cl, sel_len)
            sel = torch.where(better, cand, sel)
    best_len = _extend(w4, lens, sel, ext_cap)
    best_off = torch.where(best_len > 0, sel, 0)
    if neighbor:  # derive_neighbor: inherit p-1's match one byte shorter
        ln = _shift_down(best_len, 1) - 1
        take = (ln >= 4) & (ln > best_len)
        best_len = torch.where(take, ln, best_len)
        best_off = torch.where(take, _shift_down(best_off, 1), best_off)
    return best_len.to(torch.uint8), _as_int16(best_off)


def match_blocks(
    blocks: torch.Tensor, lens: torch.Tensor, *, rungs=(4, 16), ext_cap: int = 48,
    neighbor: bool = True, max_lag: int = 8192, prev_k: int = 1, sel_cap: int = 0,
    sel_all: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match finding for a batch of blocks: the CUDA kernel for CUDA tensors.

    blocks uint8[nb, bs] (contiguous, bs <= 65536) and lens int32[nb] on
    the same device. Returns (mlen uint8[nb, bs], mlag int16[nb, bs]) on
    that device, equal to ``match_blocks_torch``. A CPU tensor is matched by
    ``match_blocks_torch``. The launch goes on the current stream and does
    not synchronise; its device-memory scratch (a uint16 lag plane per rung
    and block, and above 32768 positions a sorted copy of each block's first
    half) is allocated here.
    """
    global LAUNCHES
    _check_inputs(blocks, lens)
    knobs = dict(
        rungs=rungs, ext_cap=ext_cap, neighbor=neighbor, max_lag=max_lag,
        prev_k=prev_k, sel_cap=sel_cap, sel_all=sel_all,
    )
    if blocks.device.type == "cpu":
        return match_blocks_torch(blocks, lens, **knobs)
    if blocks.device.type != "cuda":
        raise ValueError(f"match_blocks takes CPU or CUDA tensors, not {blocks.device}")
    if not (blocks.is_contiguous() and lens.is_contiguous()):
        raise ValueError("match_blocks needs contiguous tensors")
    rungs = check_knobs(rungs, ext_cap, max_lag, prev_k, sel_cap, sel_all)
    nb, bs = blocks.shape
    dev = blocks.device
    mlen = torch.empty((nb, bs), dtype=torch.uint8, device=dev)
    mlag = torch.empty((nb, bs), dtype=torch.int16, device=dev)
    if nb == 0:
        return mlen, mlag
    near = torch.empty((nb, len(rungs), bs), dtype=torch.int16, device=dev)
    first_half = torch.empty((nb, HALF), dtype=torch.int32, device=dev) if bs > HALF else None
    rung_mask = sum(1 << (r.bit_length() - 3) for r in rungs)  # bit i = rung 4 << i
    lib = _build.load()
    rc = lib.pim_match_blocks(
        blocks.data_ptr(), lens.data_ptr(), mlen.data_ptr(), mlag.data_ptr(),
        near.data_ptr(), first_half.data_ptr() if first_half is not None else None,
        nb, bs, rung_mask, ext_cap, int(neighbor), max_lag, prev_k, sel_cap,  # sel_cap > 0: select ladder
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"match kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return mlen, mlag
