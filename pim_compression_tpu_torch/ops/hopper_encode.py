"""Block encode: the Hopper emit kernel's wrapper, its plain PyTorch version,
and ``encode_blocks``, which chains a match kernel and the emit kernel.

``encode_blocks`` is the port of ``pim_compression_tpu.ops.pallas_encode.
encode_blocks_pallas`` with the sorted matcher in every mode it has
(block_size <= 65536) and with the sweep matcher, sampled or granular
(block_size <= 16384). For CUDA tensors it launches
``csrc/match.cu`` (``hopper_match.match_blocks``) or ``csrc/sweep.cu``
(``hopper_sweep.sweep_match``) and then ``csrc/emit.cu`` (``emit_blocks``),
which replaces the TPU kernels ``_emit_kernel`` and ``_emit_kernel_wide``
and the lazy-1 glue before them. CPU tensors go to the plain versions.

``emit_blocks_torch`` transcribes the NumPy spec the TPU kernel is held to
(``pim_compression_tpu.ops.lane_model_encode``: ``lazy_defer``,
``greedy_parse``, ``layout_and_emit``). The spec's compact/expand token
routing (``_route_tokens``) is a scatter here: token destinations rise
strictly and their byte spans are disjoint, so the route never conflicts
and lands every byte where the scatter puts it.
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus
from pim_compression_tpu_torch.ops import _build, hopper_match, hopper_sweep

# The port's encode envelope: the reference's Pallas envelope (api.py:35,
# :38-70).
MIN_BLOCK_SIZE = 256
MAX_BLOCK_SIZE = 65536
NARROW_BLOCK_SIZE = 32768  # above it the reference runs only the select ladder
WIDE_SEL_CAP = 16  # the select cap the reference's 64 KB rule defaults to

# Kernel launches since import (or since a caller reset it). The wrapper
# adds one per launch and nowhere else, so a run can show the kernel ran.
LAUNCHES = 0


def envelope_gap(config) -> str | None:
    """Why ``config`` lies outside the encode kernels' envelope, or None.

    The reference's ``_pallas_envelope_gap`` for encode
    (``runtime/api.py:38-70``), checked in its order: the block-size range
    [256, 65536], a multiple of 128, the sweep matcher above 16384, and the
    wide (64 KB) emit path without the sorted matcher (which the sweep's
    check already covers). The reference's sorted->sweep switch for sizes
    whose padded power of two exceeds 65536 has no size to act on here.
    """
    bs = config.block_size
    if not MIN_BLOCK_SIZE <= bs <= MAX_BLOCK_SIZE:
        return f"block_size outside [{MIN_BLOCK_SIZE}, {MAX_BLOCK_SIZE}]"
    if bs % 128:
        return "block_size must be a multiple of 128"
    if config.matcher == "sweep" and bs > hopper_sweep.MAX_SWEEP_BLOCK:
        return f"sweep matcher supports block_size <= {hopper_sweep.MAX_SWEEP_BLOCK} (the sweep envelope)"
    if config.matcher != "sorted" and bs > NARROW_BLOCK_SIZE:
        return "the wide (64K) emit path needs the sorted matcher"
    return None


def encode_knobs(config, notes: dict | None = None) -> dict:
    """The matcher knobs of a ``TorchCodecConfig`` on the ported path.

    The sweep matcher (``matcher="sweep"``) runs at block sizes up to 16384
    with ``match_window``, ``coarse_window`` and ``coarse_mode``, normalised
    by ``hopper_sweep.sweep_knobs``; it ignores the sorted matcher's knobs,
    as the reference does. The sorted matcher's knobs go through as the
    reference's runtime hands them on (``runtime/api.py:372-405``): above
    32768 a config without both ``sel_all`` and ``sel_cap`` becomes
    ``sel_all`` with ``sel_cap or 16`` (``notes["wide_select"]`` says so);
    the rung pick runs where ``config.effective_rung_pick`` holds and no
    ``sel_cap`` is left, the ``sel_all`` select ladder where both are set,
    and the per-rung ladder otherwise; each rung's stride is
    ``rung_strides`` or, for rungs of ``stride2_min`` bytes and up, 2; and
    ``sort_window`` passes as it is. Raises ``SnappyError(BAD_ARGUMENT)``
    outside the envelope (``envelope_gap``: there ``runtime.compress``
    takes the portable engine instead, or raises under ``strict_engine``,
    before it asks for the knobs), for granular at a block size that is not
    a multiple of 256, and for a knob the reference's sorted matcher
    refuses too (a ``sort_window`` that does not divide the padded sort
    size, a ``sel_cap`` above ``ext_cap`` after the 64 KB switch).
    """
    bs = config.block_size
    gap = envelope_gap(config)
    if gap is not None:
        raise SnappyError(
            SnappyStatus.BAD_ARGUMENT, f"encode: {gap} (block_size {bs}); runtime.compress takes the portable engine there"
        )
    sel_cap, sel_all = config.sel_cap, config.sel_all
    wide_select = bs > NARROW_BLOCK_SIZE and not (sel_all and sel_cap)
    if wide_select:
        sel_cap, sel_all = sel_cap or WIDE_SEL_CAP, True
    if config.matcher == "sweep":
        try:
            return dict(matcher="sweep", **hopper_sweep.sweep_knobs(
                bs, config.match_window, config.coarse_window, config.coarse_mode == "granular",
            ))
        except ValueError as e:
            gap = f"matcher 'sweep' at block_size {bs}: {e} (the sweep envelope; the reference refuses it too)"
    else:
        rungs = tuple(config.rungs or hopper_match.RUNGS)
        if config.rung_strides:
            strides = tuple(config.rung_strides)
        else:
            strides = tuple(2 if config.stride2_min and r >= config.stride2_min else 1 for r in rungs)
        knobs = dict(
            rungs=rungs, ext_cap=config.ext_cap, neighbor=config.neighbor,
            max_lag=config.effective_max_lag, prev_k=config.prev_k, sel_cap=sel_cap, sel_all=sel_all,
            rung_pick=config.effective_rung_pick and not sel_cap, strides=strides,
            sort_window=config.sort_window,
        )
        try:
            hopper_match.check_knobs(bs, **{k: v for k, v in knobs.items() if k != "neighbor"})
        except ValueError as e:
            gap = f"{e} (the reference's sorted matcher refuses it too, ROADMAP C)"
        else:
            if wide_select and notes is not None:
                notes["wide_select"] = f"sel_all sel_cap={sel_cap}"
            return knobs
    raise SnappyError(SnappyStatus.BAD_ARGUMENT, f"encode: {gap}")


def _check_inputs(blocks, lens, mlen, mlag, cap: int) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError("blocks must be uint8[num_blocks, block_size]")
    nb, bs = blocks.shape
    if not 0 < bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"block_size must be in (0, {MAX_BLOCK_SIZE}]")
    if cap <= 0:
        raise ValueError("cap must be positive")
    if lens.dtype != torch.int32 or lens.shape != (nb,):
        raise ValueError(f"lens must be int32[{nb}]")
    if mlen.dtype != torch.uint8 or mlen.shape != (nb, bs):
        raise ValueError(f"mlen must be uint8[{nb}, {bs}]")
    if mlag.dtype != torch.int16 or mlag.shape != (nb, bs):
        raise ValueError(f"mlag must be int16[{nb}, {bs}] (a lag's bits, read unsigned)")
    for name, t in (("lens", lens), ("mlen", mlen), ("mlag", mlag)):
        if t.device != blocks.device:
            raise ValueError(f"{name} is on {t.device}, blocks on {blocks.device}")


def emit_blocks_torch(
    blocks: torch.Tensor, lens: torch.Tensor, mlen: torch.Tensor, mlag: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch emit of a batch of blocks, on the tensors' device.

    blocks uint8[nb, bs], lens int32[nb], mlen uint8[nb, bs] (0 or 4..64)
    and mlag int16[nb, bs] (lag bits, read unsigned) from the matcher.
    Returns (comp uint8[nb, cap], sizes int32[nb]); comp bytes at or past a
    block's size are 0, and bytes that would land at or past ``cap`` are
    dropped (the caller's overflow check sees the size).
    """
    _check_inputs(blocks, lens, mlen, mlag, cap)
    nb, bs = blocks.shape
    dev = blocks.device
    length = mlen.long()
    off = mlag.long() & 0xFFFF
    nxt = torch.zeros_like(length)
    nxt[:, :-1] = length[:, 1:]
    length = torch.where(nxt > length, 0, length)  # lazy_defer

    # greedy_parse: one lockstep step per position, vectorized over blocks.
    lens_l = lens.long()
    steps = int(lens_l.max()) if nb else 0
    len_t = length.t().contiguous()
    accept_t = torch.zeros((bs, nb), dtype=torch.bool, device=dev)
    copy_t = torch.zeros((bs, nb), dtype=torch.bool, device=dev)
    next_accept = torch.zeros(nb, dtype=torch.int64, device=dev)
    for p in range(steps):
        acc = (next_accept == p) & (lens_l > p)
        copy = acc & (len_t[p] >= 4)
        accept_t[p] = acc
        copy_t[p] = copy
        next_accept = torch.where(acc, p + torch.where(copy, len_t[p], 1), next_accept)
    accept, is_copy = accept_t.t(), copy_t.t()

    # layout_and_emit: literal runs, element sizes, offsets, header bytes.
    rows = torch.arange(bs, dtype=torch.int64, device=dev).expand(nb, bs)
    in_range = rows < lens_l[:, None]
    is_lit = accept & ~is_copy
    head_lit = is_lit.clone()
    head_lit[:, 1:] &= ~is_lit[:, :-1]
    head_row = torch.cummax(torch.where(head_lit, rows, -1), dim=1).values
    nonlit_next = torch.where((accept & is_copy) | ~in_range, rows, 1 << 28)
    run_end = torch.cummin(nonlit_next.flip(1), dim=1).values.flip(1)
    run_end = torch.minimum(run_end, lens_l[:, None])
    run_len = torch.where(head_lit, run_end - rows, 0)
    l1 = (run_len - 1).clamp(min=0)
    lit_ext = torch.where(l1 < 60, 0, torch.where(l1 < 256, 1, 2))
    hdr_lit = torch.where(head_lit, 1 + lit_ext, 0)
    copy1 = is_copy & (length < 12) & (off < 2048)
    hdr_copy = torch.where(is_copy, torch.where(copy1, 2, 3), 0)
    emit = torch.where(head_lit, hdr_lit + run_len, 0) + hdr_copy
    ends = torch.cumsum(emit, dim=1)
    out_start = ends - emit
    sizes = ends[:, -1].to(torch.int32)

    is_head = accept & (head_lit | is_copy)
    elem_head = torch.cummax(torch.where(is_head, rows, -1), dim=1).values.clamp(0, bs - 1)
    cov_start = torch.gather(out_start, 1, elem_head)
    cov_hdr = torch.gather(hdr_lit + hdr_copy, 1, elem_head)
    h0 = torch.where(
        is_copy,
        torch.where(copy1, 1 | ((length - 4) << 2) | ((off >> 8) << 5), 2 | ((length - 1) << 2)),
        torch.where(head_lit, torch.where(lit_ext == 0, l1 << 2, torch.where(lit_ext == 1, 60 << 2, 61 << 2)), 0),
    )
    h1 = torch.where(is_copy, off & 0xFF, torch.where(head_lit & (lit_ext >= 1), l1 & 0xFF, 0))
    h2 = torch.where(
        is_copy & ~copy1, (off >> 8) & 0xFF, torch.where(head_lit & (lit_ext == 2), (l1 >> 8) & 0xFF, 0)
    )

    # Tokens: a head carries its 1-3 header bytes (a literal head also its
    # first data byte), every other literal position its one data byte.
    data = blocks.long()
    tok = is_head | is_lit
    dst = torch.where(is_head, out_start, cov_start + cov_hdr + rows - head_row)
    count = torch.where(is_head, hdr_lit + hdr_copy + head_lit.long(), 1)
    pay = torch.where(is_head, h0 | (h1 << 8) | (h2 << 16), data)
    pay = torch.where(head_lit, pay | (data << (8 * hdr_lit)), pay)

    # _route_tokens as a scatter; slot ``cap`` collects what lands nowhere.
    comp = torch.zeros((nb, cap + 1), dtype=torch.uint8, device=dev)
    for j in range(4):
        land = tok & (count > j) & (dst + j < cap)
        comp.scatter_(1, torch.where(land, dst + j, cap), ((pay >> (8 * j)) & 0xFF).to(torch.uint8))
    return comp[:, :cap].contiguous(), sizes


def emit_blocks(
    blocks: torch.Tensor, lens: torch.Tensor, mlen: torch.Tensor, mlag: torch.Tensor, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Emit a batch of blocks: the CUDA kernel for CUDA tensors.

    Arguments as ``emit_blocks_torch`` (contiguous, one device). Returns
    (comp uint8[nb, cap], sizes int32[nb]) equal to ``emit_blocks_torch``,
    bytes past each size included. A CPU tensor goes to
    ``emit_blocks_torch``. The launch goes on the current stream and does
    not synchronise.
    """
    global LAUNCHES
    _check_inputs(blocks, lens, mlen, mlag, cap)
    if blocks.device.type == "cpu":
        return emit_blocks_torch(blocks, lens, mlen, mlag, cap)
    if blocks.device.type != "cuda":
        raise ValueError(f"emit_blocks takes CPU or CUDA tensors, not {blocks.device}")
    if not all(t.is_contiguous() for t in (blocks, lens, mlen, mlag)):
        raise ValueError("emit_blocks needs contiguous tensors")
    nb, bs = blocks.shape
    comp = torch.empty((nb, cap), dtype=torch.uint8, device=blocks.device)
    sizes = torch.empty(nb, dtype=torch.int32, device=blocks.device)
    if nb == 0:
        return comp, sizes
    lib = _build.load()
    rc = lib.pim_emit_blocks(
        blocks.data_ptr(), lens.data_ptr(), mlen.data_ptr(), mlag.data_ptr(),
        comp.data_ptr(), sizes.data_ptr(), nb, bs, cap,
        blocks.device.index if blocks.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"emit kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return comp, sizes


def encode_blocks_torch(
    blocks: torch.Tensor, lens: torch.Tensor, *, cap: int, matcher: str = "sorted", **knobs
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain versions of both stages, on the tensors' device; ``knobs``
    as ``hopper_match.match_blocks_torch`` takes them, or with
    ``matcher="sweep"`` as ``hopper_sweep.sweep_match_torch`` does."""
    match = hopper_sweep.sweep_match_torch if matcher == "sweep" else hopper_match.match_blocks_torch
    mlen, mlag = match(blocks, lens, **knobs)
    return emit_blocks_torch(blocks, lens, mlen, mlag, cap)


def encode_blocks(
    blocks: torch.Tensor, lens: torch.Tensor, *, cap: int, matcher: str = "sorted", **knobs
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a batch of blocks: match, then emit.

    blocks uint8[nb, bs] (bs <= 65536, bytes past ``lens`` read as zero),
    lens int32[nb]; ``knobs`` as ``hopper_match.match_blocks`` takes them,
    or with ``matcher="sweep"`` (bs <= 16384) as ``hopper_sweep.sweep_match``
    does. Returns (comp uint8[nb, cap], sizes int32[nb]), the bytes
    ``lane_model_encode.encode_lanes`` emits with that matcher (lazy-1
    included). CUDA tensors run the two kernels, CPU tensors the two plain
    versions.
    """
    match = hopper_sweep.sweep_match if matcher == "sweep" else hopper_match.match_blocks
    mlen, mlag = match(blocks, lens, **knobs)
    return emit_blocks(blocks, lens, mlen, mlag, cap)
