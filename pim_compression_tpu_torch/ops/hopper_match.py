"""Match finding: the Hopper kernel's wrapper and its plain PyTorch version.

``match_blocks`` is the port of ``pim_compression_tpu.ops.pallas_match.
sorted_match_groups`` in its three selection modes (the rung pick, the
``sel_all`` select ladder and the per-rung ladder ``one_group``), at any rung
strides and sort window, at block sizes up to 65536. A CUDA tensor goes to
the hand-written kernel in ``csrc/match.cu``, which replaces the TPU kernels
``_sort_rung_kernel``, ``_extend_fold_kernel``, ``_select_extend_kernel``
and ``_prev_step_kernel`` and the XLA glue between them (lag cap, rung
pick, per-rung fold, neighbor fold). A CPU tensor goes to
``match_blocks_torch``.

``match_blocks_torch`` transcribes the NumPy spec the TPU kernels are held
to (``pim_compression_tpu.ops.lane_model_encode.match_search_sorted``, run
on the block padded to its power-of-two sort size as ``pallas_encode``
runs the kernels): per rung, a wrapping 32-bit hash ladder over the
position's L-byte prefix folded to 17 bits (16 above 32768 sorted rows),
a sort of ``(key << pos_bits) | row`` over the rows of the rung's stride,
whole or in window groups, the j-th previous row with an equal key as a
candidate lag (j up to ``prev_k`` on the 4-byte rung in the ladder modes,
1 elsewhere), the lag cap, the selection, and the neighbor fold. The tests
and ``chip_smoke.py`` use it; the ``cuda`` engine never calls it.

Both read a block's bytes at or past ``lens[b]`` as zero (the runtime's
blockize zeroes them; the spec sees those zeros). Lags reach 65535, so
``mlag`` holds the int16 bit pattern of a lag: read it unsigned
(``mlag.long() & 0xFFFF``), as the TPU's wide emit does.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as _autograd_profiler

from pim_compression_tpu_torch.ops import _build
from pim_compression_tpu_torch.runtime import profiling

# lane_model_encode.py:183-184: odd 32-bit multipliers of the hash ladder.
HASH_M1 = 0x9E3779B1
HASH_M2 = 0x85EBCA77
_M32 = 0xFFFFFFFF

RUNGS = (4, 8, 16, 32, 64)
STRIDES = (1, 2, 4, 8)
MAX_BLOCK_SIZE = 65536
MAX_EXT_CAP = 64
MAX_PREV_K = 8
MIN_SORT_WINDOW = 512
HALF = 32768  # rows the kernel sorts at once in shared memory

# Selection modes, as csrc/match.cu numbers them.
RUNG_PICK, SELECT_ALL, LADDER = 0, 1, 2

# Kernel launches since import (or since a caller reset it). The wrapper
# adds one per launch and nowhere else, so a run can show the kernel ran.
LAUNCHES = 0


def sort_size(block_size: int) -> int:
    """The power of two the reference pads a block to before its rung sorts
    (pallas_encode.py:1401-1420)."""
    return 1 << (block_size - 1).bit_length()


def pos_bits(rows: int) -> int:
    """Position bits of a sort word for a rung of ``rows`` padded sorted
    rows: 15 up to 32768, 16 above (lane_model_encode.packed_prev_lags); the
    folded key takes the rest."""
    return 15 if rows <= HALF else 16


def check_knobs(
    block_size: int, rungs, ext_cap: int, max_lag: int, prev_k: int = 1, sel_cap: int = 0,
    sel_all: bool = False, rung_pick: bool = True, strides=None, sort_window: int = 0,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Validate the matcher's knobs as the reference's sorted matcher does
    (pallas_match.py:971-1007); returns (rungs, strides) as tuples."""
    rungs = tuple(int(r) for r in rungs)
    if not rungs or any(r not in RUNGS for r in rungs) or list(rungs) != sorted(set(rungs)):
        raise ValueError(f"rungs must be an ascending subset of {RUNGS}")
    if ext_cap % 4 or not 4 <= ext_cap <= MAX_EXT_CAP:
        raise ValueError(f"ext_cap must be a multiple of 4 in [4, {MAX_EXT_CAP}]")
    if max_lag < 0:
        raise ValueError("max_lag must be >= 0 (0 = whole-block reach)")
    if not 1 <= prev_k <= MAX_PREV_K:
        raise ValueError(f"prev_k must be in [1, {MAX_PREV_K}]")
    if sel_cap % 4 or not 0 <= sel_cap <= ext_cap:
        raise ValueError("sel_cap must be 0 or a multiple of 4 in [4, ext_cap]")
    if sel_all and not sel_cap:
        raise ValueError("sel_all needs sel_cap")
    if not sel_all and rung_pick and (prev_k != 1 or sel_cap):
        raise ValueError("the rung pick takes prev_k=1 and sel_cap=0")
    strides = tuple(int(s) for s in strides) if strides is not None else (1,) * len(rungs)
    if len(strides) != len(rungs) or any(s not in STRIDES for s in strides):
        raise ValueError(f"strides must parallel rungs, each one of {STRIDES}")
    if rungs[0] == 4 and strides[0] != 1:
        raise ValueError("the 4-byte rung must stay at stride 1")
    if sort_window and (
        sort_window & (sort_window - 1) or sort_window < MIN_SORT_WINDOW
        or sort_size(block_size) % sort_window
    ):
        raise ValueError(
            f"sort_window must be a power of two >= {MIN_SORT_WINDOW} that divides the padded "
            f"sort size {sort_size(block_size)} of block_size {block_size}"
        )
    return rungs, strides


def _mode(sel_all: bool, rung_pick: bool) -> int:
    return SELECT_ALL if sel_all else RUNG_PICK if rung_pick else LADDER


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


def _prev_lags(h: torch.Tensor, prev_k: int, stride: int = 1, sort_window: int = 0) -> list[torch.Tensor]:
    """The j-th previous position with an equal folded key, as a lag (0 =
    none), for j = 1..prev_k: lane_model_encode.packed_prev_lags on the
    block padded to its power-of-two sort size. A rung of stride s keys the
    positions p = 0, s, 2s, ... by their row p / s and scales lags by s;
    other positions get 0. A window sorts each group of sort_window / s rows
    on its own and takes predecessors only from inside it."""
    nb, bs = h.shape
    rows_pad = sort_size(bs) // stride
    pb = pos_bits(rows_pad)
    hs = h[:, ::stride]
    m = hs.shape[1]
    key = (hs ^ (hs >> pb)) & ((1 << (32 - pb)) - 1)  # fold_key(h, 32 - pb)
    group = sort_window // stride if sort_window and sort_window // stride < rows_pad else m
    mg = -(-m // group) * group  # whole groups; the padded rows sort past every real word
    rows = torch.arange(mg, dtype=torch.int64, device=h.device)
    words = torch.cat([(key << pb) | rows[:m], ((1 << 40) | rows[m:]).expand(nb, mg - m)], dim=1)
    words = torch.sort(words.view(nb, mg // group, group), dim=2).values.view(nb, mg)
    spos = words & ((1 << pb) - 1)
    skey = words >> pb
    rank = rows % group  # a sorted row's place in its group
    out = []
    for j in range(1, prev_k + 1):
        same = torch.zeros_like(skey, dtype=torch.bool)
        same[:, j:] = (skey[:, j:] == skey[:, :-j]) & (rank[j:] >= j)
        lag_sorted = torch.where(same, (spos - _shift_down(spos, j)) * stride, 0)
        by_row = torch.zeros_like(lag_sorted).scatter_(1, spos, lag_sorted)
        cand = torch.zeros_like(h)
        cand[:, ::stride] = by_row[:, :m]
        out.append(cand)
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


def _cheap_fold(w4, lens, cands, cap: int, sel: torch.Tensor, sel_len: torch.Tensor):
    """The capped select: each candidate array in order gets an extension
    capped at ``cap`` bytes, and a strictly longer one wins (earlier arrays
    win ties). Returns the running (lag, capped length)."""
    for cand in cands:
        cl = _extend(w4, lens, cand, cap)
        better = cl > sel_len
        sel_len = torch.where(better, cl, sel_len)
        sel = torch.where(better, cand, sel)
    return sel, sel_len


def match_blocks_torch(
    blocks: torch.Tensor, lens: torch.Tensor, *, rungs=(4, 16), ext_cap: int = 48,
    neighbor: bool = True, max_lag: int = 8192, prev_k: int = 1, sel_cap: int = 0,
    sel_all: bool = False, rung_pick: bool = True, strides=None, sort_window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch match finding for a batch of blocks, on their device.

    blocks uint8[nb, bs] (bs <= 65536), lens int32[nb]. Returns (mlen
    uint8[nb, bs], mlag int16[nb, bs]): the match length (0 or 4..ext_cap)
    and the lag's bit pattern at every position; max_lag 0 means no reach
    cap. ``sel_all`` (with ``sel_cap`` and any ``prev_k``) runs the select
    ladder; otherwise ``rung_pick`` (``prev_k=1``, ``sel_cap=0``) the rung
    pick, and ``rung_pick=False`` the per-rung ladder (``prev_k``
    candidates on the 4-byte rung, through the capped select first when
    ``sel_cap`` and ``prev_k >= 2``). ``strides`` (parallel to ``rungs``;
    1, 2, 4 or 8, the 4-byte rung 1) and ``sort_window`` (bytes: 0, or a
    power of two >= 512 dividing the padded sort size) set each rung's sort.
    """
    _check_inputs(blocks, lens)
    nb, bs = blocks.shape
    rungs, strides = check_knobs(
        bs, rungs, ext_cap, max_lag, prev_k, sel_cap, sel_all, rung_pick, strides, sort_window
    )
    mode = _mode(sel_all, rung_pick)
    rows = torch.arange(bs, device=blocks.device)
    data = torch.where(rows[None, :] < lens[:, None], blocks, 0).long()
    w4 = _word4(data)
    zero = torch.zeros((nb, bs), dtype=torch.int64, device=blocks.device)
    sel, sel_len = zero, zero  # rung pick, select: the candidate to extend
    best_len, best_off = zero, zero  # the per-rung ladder folds into them
    h, span = w4, 4
    for length, stride in zip(rungs, strides):
        while span < length:  # _hash_ladder_step: h_2s[p] = h_s[p]*M1 ^ h_s[p+s]*M2
            h = _mul32(h, HASH_M1) ^ _mul32(_shift_up(h, span), HASH_M2)
            span *= 2
        k = prev_k if length == 4 and mode != RUNG_PICK else 1
        cands = _prev_lags(h, k, stride, sort_window)
        if max_lag:
            cands = [torch.where(c <= max_lag, c, 0) for c in cands]
        if mode == RUNG_PICK:  # the longer rung wins
            sel = torch.where(cands[0] > 0, cands[0], sel)
        elif mode == SELECT_ALL:
            sel, sel_len = _cheap_fold(w4, lens, cands, sel_cap, sel, sel_len)
        else:
            if k > 1 and sel_cap:
                cands = [_cheap_fold(w4, lens, cands, sel_cap, zero, zero)[0]]
            for cand in cands:
                el = _extend(w4, lens, cand, ext_cap)
                better = el > best_len
                best_len = torch.where(better, el, best_len)
                best_off = torch.where(better, cand, best_off)
    if mode != LADDER:
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
    sel_all: bool = False, rung_pick: bool = True, strides=None, sort_window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match finding for a batch of blocks: the CUDA kernel for CUDA tensors.

    blocks uint8[nb, bs] (contiguous, bs <= 65536) and lens int32[nb] on
    the same device; knobs as ``match_blocks_torch`` takes them. Returns
    (mlen uint8[nb, bs], mlag int16[nb, bs]) on that device, equal to
    ``match_blocks_torch``. A CPU tensor is matched by
    ``match_blocks_torch``. The launch goes on the current stream and does
    not synchronise; its device-memory scratch (a uint16 lag plane per rung
    and block, and where a rung sorts more than 32768 rows at once a sorted
    copy of each block's first half and a table of each key's last index in
    it) is allocated here. While a
    ``torch.profiler`` session records, the traced kernel runs and the
    checks, allocations and launch are host spans (``runtime/profiling.py``).
    """
    knobs = dict(
        rungs=rungs, ext_cap=ext_cap, neighbor=neighbor, max_lag=max_lag, prev_k=prev_k,
        sel_cap=sel_cap, sel_all=sel_all, rung_pick=rung_pick, strides=strides, sort_window=sort_window,
    )
    if _autograd_profiler._is_profiler_enabled and profiling.KERNEL_SPANS is not False:
        return _match_traced(blocks, lens, knobs)
    if not _on_card(blocks, lens, knobs):
        return match_blocks_torch(blocks, lens, **knobs)
    out = _outputs(blocks, knobs)
    if blocks.shape[0]:
        _launch(blocks, lens, out, knobs, None)
    return out[0], out[1]


def _match_traced(blocks, lens, knobs: dict):
    """``match_blocks`` with the traced kernel, a span around each part."""
    with torch.profiler.record_function("match_blocks.check"):
        on_card = _on_card(blocks, lens, knobs)
    if not on_card:
        return match_blocks_torch(blocks, lens, **knobs)
    with torch.profiler.record_function("match_blocks.alloc"):
        out = _outputs(blocks, knobs)
    if blocks.shape[0]:
        with torch.profiler.record_function("match_blocks.launch"):
            _launch(blocks, lens, out, knobs, profiling.launch_record("match", blocks.device))
    return out[0], out[1]


def _on_card(blocks, lens, knobs: dict) -> bool:
    """Check the arguments and, for CUDA tensors, the knobs (``knobs``
    takes the checked rungs and strides): True for CUDA tensors, False for
    CPU ones."""
    _check_inputs(blocks, lens)
    if blocks.device.type == "cpu":
        return False
    if blocks.device.type != "cuda":
        raise ValueError(f"match_blocks takes CPU or CUDA tensors, not {blocks.device}")
    if not (blocks.is_contiguous() and lens.is_contiguous()):
        raise ValueError("match_blocks needs contiguous tensors")
    knobs["rungs"], knobs["strides"] = check_knobs(
        blocks.shape[1], **{k: v for k, v in knobs.items() if k != "neighbor"})
    return True


def _outputs(blocks, knobs: dict) -> tuple:
    """(mlen, mlag, the lag planes, the sorted first halves or None, the
    tables of each 16-bit key's last index in them or None); no scratch for
    no blocks. The tables are not cleared: the kernel checks every slot it
    reads against the first half."""
    nb, bs = blocks.shape
    dev = blocks.device
    mlen = torch.empty((nb, bs), dtype=torch.uint8, device=dev)
    mlag = torch.empty((nb, bs), dtype=torch.int16, device=dev)
    if nb == 0:
        return mlen, mlag, None, None, None
    near = torch.empty((nb, len(knobs["rungs"]), bs), dtype=torch.int16, device=dev)
    # A stride-1 rung with no window sorts its 32 KB halves in turn above 32768.
    window = knobs["sort_window"]
    split = bs > HALF and 1 in knobs["strides"] and not (window and window < sort_size(bs))
    if not split:
        return mlen, mlag, near, None, None
    first_half = torch.empty((nb, HALF), dtype=torch.int32, device=dev)
    last_idx = torch.empty((nb, 1 << 16), dtype=torch.int16, device=dev)
    return mlen, mlag, near, first_half, last_idx


def _launch(blocks, lens, out: tuple, knobs: dict, trace) -> None:
    """Launch the kernel on the current stream; ``trace`` is a record's
    address for the traced kernel, or None for the plain one."""
    global LAUNCHES
    mlen, mlag, near, first_half, last_idx = out
    nb, bs = blocks.shape
    dev = blocks.device
    bits = [r.bit_length() - 3 for r in knobs["rungs"]]  # rung 4 << bit
    rung_mask = sum(1 << bit for bit in bits)
    stride_code = sum((s.bit_length() - 1) << (2 * bit) for bit, s in zip(bits, knobs["strides"]))
    lib = _build.load()
    rc = lib.pim_match_blocks(
        blocks.data_ptr(), lens.data_ptr(), mlen.data_ptr(), mlag.data_ptr(),
        near.data_ptr(), *(t.data_ptr() if t is not None else None for t in (first_half, last_idx)),
        nb, bs, rung_mask, knobs["ext_cap"], int(knobs["neighbor"]), knobs["max_lag"], knobs["prev_k"],
        knobs["sel_cap"], _mode(knobs["sel_all"], knobs["rung_pick"]), stride_code, knobs["sort_window"],
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream, trace,
    )
    if rc != 0:
        raise RuntimeError(f"match kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
