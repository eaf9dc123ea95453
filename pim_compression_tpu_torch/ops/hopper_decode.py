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
from torch.autograd import profiler as _autograd_profiler

from pim_compression_tpu_torch.ops import _build
from pim_compression_tpu_torch.runtime import profiling

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
# Parse steps a CUDA graph of the plain decode holds (``_ParseGraph``), and
# how many such graphs are kept, the most recently used (``_parse_graph``).
GRAPH_STEPS = 32
GRAPH_CACHE = 4
_GRAPHS: dict = {}

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


def _dfa_step(b, active, out_len, state, block_size: int):
    """One step of the parse DFA (lane_model.parse_dfa): byte ``b`` (int32)
    of every block, ``active`` where it lies below the block's comp_len.
    ``state`` is (mode, cnt, acc, shift, length, out_cur, err). Returns the
    next state and the byte's token: its output row (dst, -1 = none) and
    kind << 16 | value (literal byte or offset - 1, 16 bits: the wide
    path's value plane, pallas_decode.py:52-60)."""
    mode, cnt, acc, shift, length, out_cur, err = state
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

    dst = torch.where(lit_ok | copy_ok, out_cur, -1)
    val = torch.where(lit_ok, (_KIND_LIT << 16) | b, (offset - 1) & 0xFFFF)
    out_cur = out_cur + torch.where(is_lit, 1, torch.where(off_done, length, 0))
    return (n_mode, n_cnt, n_acc, n_shift, n_len, out_cur, err), dst, val


class _ParseGraph:
    """``GRAPH_STEPS`` steps of the parse DFA captured in one CUDA graph over
    static buffers of one (device, nb, cap, block_size): the bytes
    (int32 [cap, nb]), comp_len, out_len, the state, the tokens
    (int32 [cap, nb] each) and the step counter ``pos`` on the device. A
    replay reads its bytes and writes its tokens at ``pos``, writes the
    state back in place and advances ``pos``. Building one runs the steps
    eagerly once on zero buffers (the allocator's warm-up), then captures
    them: the capture synchronizes the device and empties the allocator's
    cache, once for each graph. A replay does neither."""

    def __init__(self, device, nb: int, cap: int, block_size: int):
        i32 = torch.int32
        self.comp_t = torch.zeros((cap, nb), dtype=i32, device=device)
        self.comp_len = torch.zeros(nb, dtype=i32, device=device)
        self.out_len = torch.zeros(nb, dtype=i32, device=device)
        self.state = tuple(torch.zeros(nb, dtype=i32, device=device) for _ in range(7))
        self.tok_dst = torch.zeros((cap, nb), dtype=i32, device=device)
        self.tok_val = torch.zeros((cap, nb), dtype=i32, device=device)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
        self.block_size = block_size
        self._steps()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self._steps()

    def _steps(self) -> None:
        for _ in range(GRAPH_STEPS):
            new, dst, val = _dfa_step(self.comp_t.index_select(0, self.pos)[0], self.comp_len > self.pos,
                                      self.out_len, self.state, self.block_size)
            self.tok_dst.index_copy_(0, self.pos, dst[None])
            self.tok_val.index_copy_(0, self.pos, val[None])
            for held, value in zip(self.state, new):
                if value is not held:  # err is or-ed in place
                    held.copy_(value)
            self.pos += 1

    def run(self, comp, comp_len, out_len, steps: int):
        """The first ``steps // GRAPH_STEPS`` chunks of steps of a batch,
        queued on the current stream: (the bytes [steps, nb], the tokens
        [steps, nb] each, views of the static buffers; a copy of the state;
        the steps done). The caller runs the rest on these views."""
        self.comp_t.copy_(comp.t())
        self.comp_len.copy_(comp_len)
        self.out_len.copy_(out_len)
        for t in self.state:
            t.zero_()
        self.pos.zero_()
        chunks = steps // GRAPH_STEPS
        for _ in range(chunks):
            self.graph.replay()
        state = tuple(t.clone() for t in self.state)
        return self.comp_t[:steps], self.tok_dst[:steps], self.tok_val[:steps], state, chunks * GRAPH_STEPS


def _parse_graph(device, nb: int, cap: int, block_size: int) -> _ParseGraph:
    """The cached ``_ParseGraph`` of (device, the current stream, nb, cap,
    block_size), built on a miss. A graph's buffers serve one batch at a
    time, and the calls on one stream run in its order, so each stream has
    graphs of its own. The ``GRAPH_CACHE`` most recently used are kept."""
    key = (device, torch.cuda.current_stream(device).cuda_stream, nb, cap, block_size)
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        while len(_GRAPHS) >= GRAPH_CACHE:
            _GRAPHS.pop(next(iter(_GRAPHS)))
        graph = _ParseGraph(device, nb, cap, block_size)
    _GRAPHS[key] = graph
    return graph


def decode_blocks_torch(
    comp: torch.Tensor, comp_len: torch.Tensor, out_len: torch.Tensor, block_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode of a batch of blocks, on the tensors' device.

    comp uint8[nb, cap], comp_len int32[nb], out_len int32[nb] with
    0 <= out_len <= block_size. Returns (out uint8[nb, block_size],
    err int32[nb]); bytes at or past out_len are 0. The parse takes one
    step per byte of the longest payload; on CUDA tensors the steps replay
    from a CUDA graph kept for the batch's shape (``_parse_graph``; its
    capture, once for each shape and stream, synchronizes the device), on
    CPU tensors they run one by one.
    """
    _check_inputs(comp, comp_len, out_len, block_size)
    if out_len.numel() and (int(out_len.min()) < 0 or int(out_len.max()) > block_size):
        raise ValueError(f"out_len must lie in [0, {block_size}]")
    dev = comp.device
    nb, cap = comp.shape
    i32 = torch.int32
    # The DFA's state: mode, cnt, acc, shift, length, out_cur, err.
    state = tuple(torch.zeros(nb, dtype=i32, device=dev) for _ in range(7))

    # Stage 1, parse DFA (lane_model.parse_dfa): one byte of every block per
    # step. Each routed byte or copy record becomes a token: its output row
    # (dst, -1 = none) and kind << 16 | value (literal byte or offset - 1,
    # 16 bits: the wide path's value plane, pallas_decode.py:52-60).
    steps = max(0, min(cap, int(comp_len.max()))) if nb else 0
    if dev.type == "cuda" and steps >= 2 * GRAPH_STEPS:
        comp_t, tok_dst, tok_val, state, done = _parse_graph(dev, nb, cap, block_size).run(
            comp, comp_len, out_len, steps)
    else:
        comp_t = comp[:, :steps].t().to(i32)  # [steps, nb]
        tok_dst = torch.full((steps, nb), -1, dtype=i32, device=dev)
        tok_val = torch.zeros((steps, nb), dtype=i32, device=dev)
        done = 0
    for p in range(done, steps):
        state, tok_dst[p], tok_val[p] = _dfa_step(comp_t[p], comp_len > p, out_len, state, block_size)
    mode, _, _, _, _, out_cur, err = state

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
    not synchronise. While a ``torch.profiler`` session records, the traced
    kernel runs and the checks, allocations and launch are host spans
    (``runtime/profiling.py``).
    """
    if _autograd_profiler._is_profiler_enabled and profiling.KERNEL_SPANS is not False:
        return _decode_traced(comp, comp_len, out_len, block_size)
    if not _on_card(comp, comp_len, out_len, block_size):
        return decode_blocks_torch(comp, comp_len, out_len, block_size)
    out, err = _outputs(comp, block_size)
    if out.shape[0]:
        _launch(comp, comp_len, out_len, out, err, block_size, None)
    return out, err


def _decode_traced(comp, comp_len, out_len, block_size: int):
    """``decode_blocks`` with the traced kernel, a span around each part."""
    with torch.profiler.record_function("decode_blocks.check"):
        on_card = _on_card(comp, comp_len, out_len, block_size)
    if not on_card:
        return decode_blocks_torch(comp, comp_len, out_len, block_size)
    with torch.profiler.record_function("decode_blocks.alloc"):
        out, err = _outputs(comp, block_size)
    if out.shape[0]:
        with torch.profiler.record_function("decode_blocks.launch"):
            _launch(comp, comp_len, out_len, out, err, block_size, profiling.launch_record("decode", comp.device))
    return out, err


def _on_card(comp, comp_len, out_len, block_size: int) -> bool:
    """Check the arguments: True for CUDA tensors, False for CPU ones."""
    _check_inputs(comp, comp_len, out_len, block_size)
    if comp.device.type == "cpu":
        return False
    if comp.device.type != "cuda":
        raise ValueError(f"decode_blocks takes CPU or CUDA tensors, not {comp.device}")
    if not (comp.is_contiguous() and comp_len.is_contiguous() and out_len.is_contiguous()):
        raise ValueError("decode_blocks needs contiguous tensors")
    return True


def _outputs(comp, block_size: int):
    nb = comp.shape[0]
    return (torch.empty((nb, block_size), dtype=torch.uint8, device=comp.device),
            torch.empty(nb, dtype=torch.int32, device=comp.device))


def _launch(comp, comp_len, out_len, out, err, block_size: int, trace) -> None:
    """Launch the kernel on the current stream; ``trace`` is a record's
    address for the traced kernel, or None for the plain one."""
    global LAUNCHES
    nb, cap = comp.shape
    lib = _build.load()
    rc = lib.pim_decode_blocks(
        comp.data_ptr(), comp_len.data_ptr(), out_len.data_ptr(),
        out.data_ptr(), err.data_ptr(), nb, cap, block_size,
        comp.device.index if comp.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(comp.device).cuda_stream, trace,
    )
    if rc != 0:
        raise RuntimeError(f"decode kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1


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
