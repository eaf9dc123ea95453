"""Block decode: the Hopper kernel's wrapper and its plain PyTorch version.

``decode_blocks`` is the port of ``pim_compression_tpu.ops.pallas_decode.
decode_blocks_pallas`` on its narrow (block_size <= 32768) and wide
(32768 < block_size <= 65536) paths. A CUDA tensor goes to the hand-written
kernel in ``csrc/decode.cu``, which replaces the TPU kernels of both paths
(``_dfa_kernel``, ``_route_kernel`` and ``_route_kernel_wide``). A CPU
tensor goes to ``decode_blocks_torch``.

``decode_blocks_torch`` transcribes the NumPy spec the TPU kernels are held
to (``pim_compression_tpu.ops.lane_model``: ``parse_dfa``,
``butterfly_route``, ``fill_and_resolve``, ``decode_lanes``) and gives the
same output bytes and error bits, on CPU or CUDA tensors. The tests and
``chip_smoke.py`` use it; the main path never calls it on a CUDA tensor.
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.ops import _build

# Error bits (pim_compression_tpu/ops/lane_model.py:37-41).
ERR_LENGTH_MISMATCH = 1
ERR_BAD_OFFSET = 2
ERR_ELEMENT_OVERRUN = 4
ERR_ROUTE_CONFLICT = 8
ERR_UNRESOLVED = 16

MAX_BLOCK_SIZE = 65536  # the format's largest block

# DFA modes (lane_model.TAG/EXT/LIT/OFF).
_TAG, _EXT, _LIT, _OFF = 0, 1, 2, 3
_KIND_LIT = 1
_RESOLVE_ROUNDS = 16

# Kernel launches since import (or since a caller reset it). The wrapper
# adds one per launch and nowhere else, so a run can show the kernel ran.
LAUNCHES = 0


def _check_inputs(comp, comp_len, out_len, block_size: int) -> None:
    if not 0 < block_size <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size must be in (0, {MAX_BLOCK_SIZE}]")
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise ValueError("comp must be uint8[num_blocks, cap]")
    nb = comp.shape[0]
    for name, t in (("comp_len", comp_len), ("out_len", out_len)):
        if t.dtype != torch.int32 or t.shape != (nb,):
            raise ValueError(f"{name} must be int32[{nb}]")
        if t.device != comp.device:
            raise ValueError(f"{name} is on {t.device}, comp on {comp.device}")


def decode_blocks_torch(
    comp: torch.Tensor, comp_len: torch.Tensor, out_len: torch.Tensor, block_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode of a batch of blocks, on the tensors' device.

    comp uint8[nb, cap], comp_len int32[nb], out_len int32[nb] with
    0 <= out_len <= block_size. Returns (out uint8[nb, block_size],
    err int32[nb]); bytes at or past out_len are 0.
    """
    _check_inputs(comp, comp_len, out_len, block_size)
    if out_len.numel() and (int(out_len.min()) < 0 or int(out_len.max()) > block_size):
        raise ValueError(f"out_len must lie in [0, {block_size}]")
    dev = comp.device
    nb, cap = comp.shape
    i32 = torch.int32
    zero = torch.zeros(nb, dtype=i32, device=dev)
    mode, cnt, acc, shift, length, out_cur, err = (zero.clone() for _ in range(7))

    # Stage 1, parse DFA (lane_model.parse_dfa): one byte of every block per
    # step. Each routed byte or copy record becomes a token: its output row
    # (dst, -1 = none) and kind << 16 | value (literal byte or offset - 1,
    # 16 bits: the wide path's value plane, pallas_decode.py:52-60).
    steps = max(0, min(cap, int(comp_len.max()))) if nb else 0
    comp_t = comp[:, :steps].t().to(i32)  # [steps, nb]
    tok_dst = torch.full((steps, nb), -1, dtype=i32, device=dev)
    tok_val = torch.zeros((steps, nb), dtype=i32, device=dev)
    for p in range(steps):
        b = comp_t[p]
        active = comp_len > p
        is_tag = active & (mode == _TAG)
        is_ext = active & (mode == _EXT)
        is_lit = active & (mode == _LIT)
        is_off = active & (mode == _OFF)
        kind = b & 3
        lf = b >> 2

        # TAG transitions.
        t_lit = is_tag & (kind == 0)
        t_lit_inline = t_lit & (lf < 60)
        t_lit_ext = t_lit & (lf >= 60)
        t_copy1 = is_tag & (kind == 1)
        t_copy = is_tag & (kind != 0)
        t_copy24 = t_copy & ~t_copy1
        n_mode = torch.where(t_lit_inline, _LIT, mode)
        n_mode = torch.where(t_lit_ext, _EXT, n_mode)
        n_mode = torch.where(t_copy, _OFF, n_mode)
        n_cnt = torch.where(t_lit_inline, lf + 1, cnt)
        n_cnt = torch.where(t_lit_ext, lf - 59, n_cnt)
        n_cnt = torch.where(t_copy, torch.where(kind == 3, 4, kind), n_cnt)
        n_len = torch.where(t_lit_inline | t_copy24, lf + 1, length)
        n_len = torch.where(t_copy1, ((b >> 2) & 7) + 4, n_len)
        starts = t_lit_ext | t_copy
        n_acc = torch.where(starts, torch.where(t_copy1, (b >> 5) << 8, 0), acc)
        n_shift = torch.where(starts, 0, shift)

        # EXT / OFF: accumulate little-endian bytes below bit 24.
        is_acc = is_ext | is_off
        byte = torch.where(is_acc & (shift < 24), b << shift.clamp(max=16), 0)
        high = is_acc & (shift >= 24) & (b > 0)
        n_acc = torch.where(is_acc, acc + byte, n_acc)
        n_shift = torch.where(is_acc, shift + 8, n_shift)
        n_cnt = torch.where(is_acc | is_lit, cnt - 1, n_cnt)
        last = cnt == 1
        err |= torch.where(is_ext & high, ERR_ELEMENT_OVERRUN, 0)
        ext_done = is_ext & last
        n_len = torch.where(ext_done, n_acc + 1, n_len)
        n_cnt = torch.where(ext_done, n_acc + 1, n_cnt)
        n_mode = torch.where(ext_done, _LIT, n_mode)

        # LIT: route this byte to its output row.
        lit_ok = is_lit & (out_cur < out_len)
        err |= torch.where(is_lit & ~lit_ok, ERR_LENGTH_MISMATCH, 0)
        n_mode = torch.where(is_lit & last, _TAG, n_mode)

        # OFF complete: check the offset and emit the copy record.
        off_done = is_off & last
        offset = n_acc
        bad_off = off_done & ((offset <= 0) | (offset > out_cur) | (offset > block_size) | high)
        err |= torch.where(bad_off, ERR_BAD_OFFSET, 0)
        err |= torch.where(off_done & (out_cur + length > out_len), ERR_LENGTH_MISMATCH, 0)
        copy_ok = off_done & ~bad_off & (out_cur < out_len)
        n_mode = torch.where(off_done, _TAG, n_mode)

        tok_dst[p] = torch.where(lit_ok | copy_ok, out_cur, -1)
        tok_val[p] = torch.where(lit_ok, (_KIND_LIT << 16) | b, (offset - 1) & 0xFFFF)
        out_cur = out_cur + torch.where(is_lit, 1, torch.where(off_done, length, 0))
        mode, cnt, acc, shift, length = n_mode, n_cnt, n_acc, n_shift, n_len

    err |= torch.where((mode != _TAG) & (comp_len > 0), ERR_ELEMENT_OVERRUN, 0)
    err |= torch.where(out_cur != out_len, ERR_LENGTH_MISMATCH, 0)

    # Stage 2, route (lane_model.butterfly_route): move each token to row dst.
    # Token rows are strictly increasing in dst (every element advances
    # out_cur) and below out_len <= block_size, so the butterfly never
    # conflicts and is exactly this scatter; ERR_ROUTE_CONFLICT cannot arise.
    # Row block_size collects the empty slots and is dropped.
    lanes = torch.arange(nb, device=dev).expand(steps, nb)
    dst = torch.where(tok_dst >= 0, tok_dst, block_size).long()
    routed = torch.full((block_size + 1, nb), -1, dtype=i32, device=dev)
    routed[dst, lanes] = tok_val
    routed = routed[:block_size]

    # Stage 3, fill and resolve (lane_model.fill_and_resolve): a prefix max
    # of row << 17 | kind << 16 | value (int64: a 64 KB block's rows take 16
    # bits) gives every row its covering element; literal rows hold
    # -(byte + 1), copy rows point back by the offset; then pointer doubling
    # follows the copy chains to their literal bytes.
    rows = torch.arange(block_size, dtype=i32, device=dev)[:, None]
    occupied = routed >= 0
    packed = torch.where(occupied, (rows.long() << 17) | routed, -1)
    packed = torch.cummax(packed, dim=0).values
    cov_kind = (packed >> 16) & 1
    cov_value = (packed & 0xFFFF).int()
    is_lit_row = occupied & (((routed >> 16) & 1) == _KIND_LIT)
    S = torch.where(is_lit_row, -((routed & 0xFF) + 1), rows - (cov_value + 1))
    in_range = rows < out_len[None, :]
    bad = in_range & ~is_lit_row & ((cov_kind != 0) | (S >= rows) | (S < 0))
    err |= torch.where(bad.any(dim=0), ERR_BAD_OFFSET, 0)
    S = torch.where(bad | ~in_range, -1, S)
    for _ in range(_RESOLVE_ROUNDS):
        live = S >= 0
        if not bool(live.any()):
            break
        S = torch.where(live, torch.gather(S, 0, S.clamp(0, block_size - 1).long()), S)
    err |= torch.where((S >= 0).any(dim=0), ERR_UNRESOLVED, 0)
    out = torch.where(in_range, -S - 1, 0).to(torch.uint8)
    return out.t().contiguous(), err


def decode_blocks(
    comp: torch.Tensor, comp_len: torch.Tensor, out_len: torch.Tensor, *, block_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of blocks: the CUDA kernel for CUDA tensors.

    comp uint8[nb, cap] (contiguous), comp_len and out_len int32[nb] on the
    same device, 0 <= out_len <= block_size <= 65536. Any number of blocks.
    Returns (out uint8[nb, block_size], err int32[nb]) on that device; err
    holds the parse DFA's bits. A CPU tensor is decoded by
    ``decode_blocks_torch``. The launch goes on the current stream and does
    not synchronise.
    """
    global LAUNCHES
    _check_inputs(comp, comp_len, out_len, block_size)
    if comp.device.type == "cpu":
        return decode_blocks_torch(comp, comp_len, out_len, block_size)
    if comp.device.type != "cuda":
        raise ValueError(f"decode_blocks takes CPU or CUDA tensors, not {comp.device}")
    if not (comp.is_contiguous() and comp_len.is_contiguous() and out_len.is_contiguous()):
        raise ValueError("decode_blocks needs contiguous tensors")
    nb, cap = comp.shape
    out = torch.empty((nb, block_size), dtype=torch.uint8, device=comp.device)
    err = torch.empty(nb, dtype=torch.int32, device=comp.device)
    if nb == 0:
        return out, err
    lib = _build.load()
    rc = lib.pim_decode_blocks(
        comp.data_ptr(), comp_len.data_ptr(), out_len.data_ptr(),
        out.data_ptr(), err.data_ptr(), nb, cap, block_size,
        comp.device.index if comp.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(comp.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, err


def walks_per_sm(device=None) -> int:
    """Blocks the decode kernel walks at once on one SM of a CUDA device:
    the CTAs that fit (CUDA's occupancy query) times the warps of a CTA,
    one block a warp. Its shared memory does not depend on the block size
    or cap, so neither does this."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"walks_per_sm needs a CUDA device, not {dev}")
    walks = _build.load().pim_decode_walks_per_sm(dev.index if dev.index is not None else torch.cuda.current_device())
    if walks <= 0:
        raise RuntimeError(f"decode kernel occupancy query failed: CUDA error {-walks}")
    return walks
