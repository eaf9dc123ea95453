"""Shared data-parallel primitives of the portable engine (the port of
``pim_compression_tpu.ops.primitives``).

Plain PyTorch tensor ops (gathers, cumsums, selects; no scatter in the hot
paths, no data-dependent Python control flow and so no host sync), batched
over a leading block axis where the reference ``vmap``s one block. Every
gather is ``torch.gather`` along the last dimension with int64 indices; its
index is clipped exactly where the reference clips it or is in range by
construction (``torch.gather`` raises where ``jnp.take`` would fill or wrap).
Values keep the reference's int32.

The key primitive family is *pointer doubling* over a functional successor
``next: [0, n] -> [0, n]``: squaring the successor log2(n) times turns every
serial chain walk into a fixed number of batched gathers.
"""

from __future__ import annotations

import torch


def ceil_log2(n: int) -> int:
    return max(1, (int(n) - 1).bit_length())


def take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[b, index[b, j]]`` for every block b: ``jnp.take`` of one
    block, batched. ``index`` must lie in ``[0, values.shape[-1])``."""
    return torch.gather(values, -1, index.long())


def select(cond: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``jnp.where(cond, a, b)`` of two int32 constants: int32, where
    ``torch.where`` of two Python ints would give int64."""
    return torch.full(cond.shape, b, dtype=torch.int32, device=cond.device).masked_fill_(cond, a)


def orbit_positions(next_fn: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Positions visited by iterating ``next_fn`` from node 0, per block.

    ``next_fn`` is int32[nb, n] mapping node -> successor in [0, n)
    (terminal nodes must self-loop). Returns int32[nb, num_steps] with
    ``pos[b, j] = next_fn[b]^j(0)``, one gather per bit of ``j`` (powers of
    one function commute, so bits can be applied in any order).
    """
    nb = next_fn.shape[0]
    steps = torch.arange(num_steps, dtype=torch.int32, device=next_fn.device)
    pos = torch.zeros((nb, num_steps), dtype=torch.int32, device=next_fn.device)
    jump = next_fn
    for bit in range(ceil_log2(num_steps)):
        pos = torch.where((steps >> bit) & 1 == 1, take(jump, pos), pos)
        jump = take(jump, jump)
    return pos


def resolve_copy_chains(src: torch.Tensor, num_rounds: int) -> torch.Tensor:
    """Resolve backreference chains by pointer doubling, per block.

    ``src[b, i] >= 0`` means "output position i copies from output position
    src[b, i]" (strictly src < i for valid streams); ``src[b, i] < 0``
    encodes a terminal (literal) source as ``-(index)-1``.

    Runs exactly ``num_rounds`` rounds. The reference's ``while_loop`` also
    stops as soon as no pointer is left (``jnp.any(s >= 0)`` false); a
    Python loop on that test would wait for the device every round. The
    fixed count gives the same result: a resolved entry is negative and
    ``where(s >= 0, hop, s)`` leaves it alone, a self-loop (src[i] == i, an
    invalid stream that the caller's error flags catch) stays non-negative
    either way, and under ``vmap`` the reference's loop already runs until
    the slowest block of its batch is resolved or the cap is reached.
    """
    n = src.shape[-1]
    for _ in range(num_rounds):
        hop = take(src, src.clamp(0, n - 1))
        src = torch.where(src >= 0, hop, src)
    return src


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, in int32 as ``jnp.cumsum``
    of an int32 array (``torch.cumsum`` would widen to int64)."""
    return torch.cumsum(x, dim=-1, dtype=torch.int32) - x


def covering_element(starts: torch.Tensor, num_out: int) -> torch.Tensor:
    """For each output index i in [0, num_out), the index j of the covering
    element: max{j : starts[b, j] <= i} with ``starts[b]`` nondecreasing
    (0 where no start is <= i). int32[nb, num_out].

    The vectorized replacement for "which element am I inside" that the
    serial decoders answer implicitly by walking the stream.
    """
    nb = starts.shape[0]
    idx = torch.arange(num_out, dtype=starts.dtype, device=starts.device).expand(nb, num_out).contiguous()
    j = torch.searchsorted(starts.contiguous(), idx, right=True, out_int32=True) - 1
    return torch.clamp_min(j, 0)
