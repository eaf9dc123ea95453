"""Data-parallel block encoder of the portable engine (the port of
``pim_compression_tpu.ops.encode``): plain PyTorch tensor ops on the
inputs' device, no hand-written kernel. It emits the reference ``xla``
engine's stream, which is not the ``pallas`` one (another match finder).

1. **Exact previous-occurrence matching**: a stable sort of each block's
   4-grams; the predecessor with an equal gram in sorted order is the most
   recent previous occurrence, and the k-th such predecessor the k-th.
2. **Match lengths**: lock-step shifted byte comparisons, at most 64 (a
   copy element emits at most 64 bytes; a longer match continues as chained
   copies). With ``prev_k > 1`` every candidate gets a ``sel_cap``-byte
   probe first and only the winner is extended.
3. **Lazy-1 and greedy parse**: ``step(p) = p + match_len(p)`` (or +1 for a
   literal); the chosen elements are the orbit of 0 under ``step``.
4. **Literal coalescing**: runs of chosen literal bytes merge into single
   literal elements (head detection + reverse cummin).
5. **Emission**: per-element sizes -> exclusive cumsum -> every output byte
   finds its element by ``searchsorted`` and computes itself (a header byte
   or a literal data byte). No scatter in the emit.

Nothing here waits for the device (no boolean-mask indexing, no ``.item()``).
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.format import constants as C
from pim_compression_tpu_torch.ops import primitives as P
from pim_compression_tpu_torch.runtime.pipeline import padded_capacity

_INF = 1 << 30


def _previous_occurrences(gram: torch.Tensor, valid: torch.Tensor, prev_k: int) -> list[torch.Tensor]:
    """The ``prev_k`` most recent q < p with gram[b, q] == gram[b, p] (-1 =
    none), int32[nb, bs] each.

    A stable sort by gram keeps positions ascending within equal grams, so
    the k-th in-sort predecessor with an equal key is exactly the k-th most
    recent previous occurrence. One sort serves every k.
    """
    gram_s, pos_s = torch.sort(gram, dim=-1, stable=True)
    pos_s32 = pos_s.to(torch.int32)
    prevs = []
    for k in range(1, prev_k + 1):
        cand = torch.full_like(gram, -1)
        if k < gram.shape[-1]:
            same_k = gram_s[:, k:] == gram_s[:, :-k]
            cand[:, k:] = torch.where(same_k, pos_s32[:, :-k], -1)
        prev = torch.zeros_like(gram).scatter_(-1, pos_s, cand)
        prevs.append(torch.where(valid, prev, -1))
    return prevs


def _match_lengths(
    d8: torch.Tensor,
    prev: torch.Tensor,
    rem: torch.Tensor,
    block_size: int,
    cap: int = C.MAX_COPY_LEN,
    start: torch.Tensor | None = None,
) -> torch.Tensor:
    """Common-prefix length between p and prev[b, p], capped at ``cap``.

    ``d8`` is the blocks padded with MAX_COPY_LEN zeros, uint8[nb, bs + 64];
    ``rem`` is ``n - p``, so ``p + q < n`` reads ``q < rem``. ``start``
    (per position) resumes counting from a known-equal prefix: the
    select-then-extend pattern. Every step runs, as the reference's
    ``fori_loop`` does; the byte at ``p + q`` is a shifted slice where
    ``q`` is the step alone (it stays below the clamp ``bs + 63`` then).
    """
    limit = block_size + C.MAX_COPY_LEN - 1
    alive = prev >= 0
    prev_c = prev.clamp_min(0).long()
    if start is None:
        ml = torch.zeros_like(prev)
        for t in range(min(cap, C.MAX_COPY_LEN)):  # q = t < MAX_COPY_LEN
            a = d8[:, t : t + block_size]
            b = torch.gather(d8, -1, prev_c + t)  # prev_c + t <= limit
            alive &= (a == b) & (rem > t)
            ml += alive
        return ml
    pos = torch.arange(block_size, dtype=torch.int64, device=d8.device)
    q0 = start.long()
    ml = start.clone()
    for t in range(cap):
        q = q0 + t
        a = torch.gather(d8, -1, (pos + q).clamp_max(limit))
        b = torch.gather(d8, -1, (prev_c + q).clamp_max(limit))
        alive &= (a == b) & (rem > q) & (q < C.MAX_COPY_LEN)
        ml += alive
    return ml


def _check_inputs(data, lens) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError("data must be uint8[num_blocks, block_size]")
    nb, bs = data.shape
    if not 0 < bs <= C.MAX_BLOCK_SIZE:
        raise ValueError(f"block_size must be in (0, {C.MAX_BLOCK_SIZE}]")
    if lens.dtype != torch.int32 or lens.shape != (nb,):
        raise ValueError(f"lens must be int32[{nb}]")
    if lens.device != data.device:
        raise ValueError(f"lens is on {lens.device}, data on {data.device}")


def encode_blocks(
    data: torch.Tensor,
    lens: torch.Tensor,
    *,
    block_size: int = C.DEFAULT_BLOCK_SIZE,
    prev_k: int = 2,
    sel_cap: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a batch of independent blocks on the inputs' device.

    data uint8[nb, block_size] (bytes past a block's length must be the
    runtime's zeros: the 4-grams of its last positions read them), lens
    int32[nb] in [0, block_size]. Returns ``(comp, sizes)``: padded payloads
    uint8[nb, padded_capacity(block_size)] (zero past each size) and the
    true compressed sizes int32[nb], equal to the reference's
    ``encode_blocks`` at the same ``prev_k`` and ``sel_cap``.
    """
    _check_inputs(data, lens)
    if data.shape[1] != block_size:
        raise ValueError(f"data has {data.shape[1]} columns, block_size is {block_size}")
    dev = data.device
    bs = block_size
    cap = padded_capacity(bs)
    n = lens[:, None]
    pos = torch.arange(bs, dtype=torch.int32, device=dev)
    d8 = torch.nn.functional.pad(data, (0, C.MAX_COPY_LEN))
    d32 = d8.to(torch.int32)

    gram = d32[:, :bs] | (d32[:, 1 : bs + 1] << 8) | (d32[:, 2 : bs + 2] << 16) | (d32[:, 3 : bs + 3] << 24)
    cands = _previous_occurrences(gram, pos + C.MIN_MATCH_LEN <= n, prev_k)
    del gram, d32
    rem = n - pos
    if prev_k == 1:
        prev = cands[0]
        ml = _match_lengths(d8, prev, rem, bs)
    else:
        # Select-then-extend over the prev-k ladder: every candidate gets a
        # cheap sel_cap-byte probe; the nearest longest-probing candidate
        # wins and resumes its extension from the probed prefix.
        probes = [_match_lengths(d8, c, rem, bs, cap=sel_cap) for c in cands]
        prev = cands[0]
        best = probes[0]
        for c, p in zip(cands[1:], probes[1:]):
            better = p > best
            prev = torch.where(better, c, prev)
            best = torch.where(better, p, best)
        del probes, cands
        ml = _match_lengths(d8, prev, rem, bs, cap=C.MAX_COPY_LEN - sel_cap, start=best)
        del best
    del rem
    ml = torch.where(ml >= C.MIN_MATCH_LEN, ml, 0)
    # Lazy-1 matching: defer a copy when the next position matches longer.
    nxt_ml = torch.nn.functional.pad(ml[:, 1:], (0, 1))
    ml = torch.where(nxt_ml > ml, 0, ml)
    del nxt_ml

    # Greedy parse: orbit of 0 under step.
    step_to = torch.where(ml > 0, pos + ml, pos + 1)
    nxt = torch.minimum(torch.cat([step_to, n], dim=1), n)
    nodes = torch.arange(bs + 1, dtype=torch.int32, device=dev)
    nxt = torch.where(nodes >= n, n, nxt)
    del step_to
    elem_pos = P.orbit_positions(nxt, bs)  # <= block_size elements
    del nxt
    e_valid = elem_pos < n

    safe_pos = elem_pos.clamp(0, bs - 1).long()
    e_ml = torch.where(e_valid, torch.gather(ml, -1, safe_pos), 0)
    e_iscopy = e_valid & (e_ml > 0)
    e_islit = e_valid & (e_ml == 0)
    e_off = torch.where(e_iscopy, safe_pos.to(torch.int32) - torch.gather(prev, -1, safe_pos), 0)
    del ml, prev, safe_pos

    # Literal-run coalescing. Consecutive chosen literals are consecutive
    # positions, so a run spans from its head to the next copy/stream end.
    prev_islit = torch.nn.functional.pad(e_islit[:, :-1], (1, 0))
    head = e_islit & ~prev_islit
    nonlit_pos = torch.where(e_iscopy, elem_pos, torch.where(e_valid, _INF, n))
    run_end = torch.cummin(nonlit_pos.flip(-1), dim=-1).values.flip(-1)
    run_len = torch.where(head, torch.minimum(run_end, n) - elem_pos, 0)
    del prev_islit, nonlit_pos, run_end, e_islit

    # Per-element emitted sizes.
    lit_ext = torch.where(run_len - 1 < 60, 0, P.select(run_len - 1 < 256, 1, 2))
    lit_size = torch.where(head, 1 + lit_ext + run_len, 0)
    copy1 = e_iscopy & (e_ml < 12) & (e_off < C.COPY1_MAX_OFFSET)
    copy_size = torch.where(e_iscopy, P.select(copy1, 2, 3), 0)
    e_size = lit_size + copy_size
    e_start = P.exclusive_cumsum(e_size)
    comp_size = e_start[:, -1:] + e_size[:, -1:]
    del lit_size, copy_size, e_size, head

    # Header bytes (up to 3 per element).
    L1 = run_len - 1
    h0 = torch.where(
        e_iscopy,
        torch.where(
            copy1,
            C.ElementType.COPY_1_BYTE_OFFSET | ((e_ml - 4) << 2) | ((e_off >> 8) << 5),
            C.ElementType.COPY_2_BYTE_OFFSET | ((e_ml - 1) << 2),
        ),
        torch.where(lit_ext == 0, L1 << 2, P.select(lit_ext == 1, 60 << 2, 61 << 2)),
    )
    h1 = torch.where(e_iscopy, e_off & 0xFF, torch.where(lit_ext >= 1, L1 & 0xFF, 0))
    h2 = torch.where(e_iscopy, (e_off >> 8) & 0xFF, torch.where(lit_ext == 2, (L1 >> 8) & 0xFF, 0))
    hdr_len = torch.where(e_iscopy, P.select(copy1, 2, 3), 1 + lit_ext)
    del L1, e_ml, e_off, e_iscopy, copy1, lit_ext, run_len, e_valid

    # Emit: every output byte derives itself from its covering element.
    # e_start is nondecreasing; absorbed/invalid elements have size 0 and so
    # share the *next* emitter's start, which makes "last element with
    # start <= q" always land on an emitting element.
    q = torch.arange(cap, dtype=torch.int32, device=dev)
    cov = (P.covering_element(e_start, cap)).clamp_max(bs - 1).long()
    c_start = torch.gather(e_start, -1, cov)
    c_hdr = torch.gather(hdr_len, -1, cov)
    c_pos = torch.gather(elem_pos, -1, cov)
    rel = q - c_start
    del c_start, e_start, hdr_len, elem_pos
    hdr_byte = torch.where(
        rel == 0,
        torch.gather(h0, -1, cov),
        torch.where(rel == 1, torch.gather(h1, -1, cov), torch.gather(h2, -1, cov)),
    )
    del cov, h0, h1, h2
    data_byte = P.take(d8, (c_pos + (rel - c_hdr)).clamp(0, bs - 1))
    out = torch.where(rel < c_hdr, hdr_byte, data_byte.to(torch.int32))
    out = torch.where(q < comp_size, out, 0).to(torch.uint8)
    return out, comp_size[:, 0]
