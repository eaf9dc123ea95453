"""Fully data-parallel block decoder of the portable engine (the port of
``pim_compression_tpu.ops.decode``): plain PyTorch tensor ops on the
inputs' device, no hand-written kernel.

Every stage is a fixed-depth batch of vector ops over ``[num_blocks, ...]``:

1. **Speculative tag decode**: a tag at *every* byte position of the padded
   compressed block at once (its element kind, output length, offset and
   stream advance, as if a tag started there).
2. **Tag-chain discovery**: the true tags are the orbit of position 0 under
   the per-position ``advance`` successor (``primitives.orbit_positions``).
3. **Output layout**: per-element output lengths -> exclusive cumsum ->
   ``searchsorted`` maps every output byte to its covering element.
4. **Copy resolution**: every output byte gets a source pointer (a negative
   literal index into the compressed bytes, or ``i - offset`` for copies),
   and pointer doubling (``primitives.resolve_copy_chains``) collapses
   copy chains, overlapping run copies included.
5. **Literal gather**: one final gather from the compressed bytes.

Nothing here waits for the device: no boolean-mask indexing and no
``.item()``; every select is a ``torch.where`` (``primitives.select`` for
two constants), as in the reference.
"""

from __future__ import annotations

import torch

from pim_compression_tpu_torch.format import constants as C
from pim_compression_tpu_torch.ops import hopper_decode
from pim_compression_tpu_torch.ops import primitives as P
from pim_compression_tpu_torch.runtime.pipeline import padded_capacity  # noqa: F401  (the shared capacity model)

# Error flag bits (per block).
ERR_LENGTH_MISMATCH = 1  # decoded size != expected size
ERR_BAD_OFFSET = 2  # copy offset 0 or reaching before block start
ERR_ELEMENT_OVERRUN = 4  # element extends past the compressed payload

# Sentinel added to oversized length/offset fields so they stay in int32
# while still tripping the validity checks (real values are < 2**17).
_TOO_BIG = 1 << 26


def _speculative_tags(comp_i32: torch.Tensor, cap: int) -> dict[str, torch.Tensor]:
    """Decode a tag at every position p of each padded block.

    ``comp_i32`` is int32[nb, cap + 4] (4 trailing zeros so shifted views
    are always in bounds). Returns per-position element descriptors,
    int32[nb, cap] (``is_lit`` bool).
    """
    c0 = comp_i32[:, :cap]
    c1 = comp_i32[:, 1 : cap + 1]
    c2 = comp_i32[:, 2 : cap + 2]
    c3 = comp_i32[:, 3 : cap + 3]
    c4 = comp_i32[:, 4 : cap + 4]

    kind = c0 & 3
    lf = c0 >> 2

    # Literal lengths: inline (lf < 60) or lf-59 extra LE bytes whose value+1
    # is the length. A 4th length byte would exceed any block size; clamp via
    # sentinel instead of overflowing int32.
    k = lf - 59  # 1..4 when lf >= 60
    ext_len = torch.where(k >= 1, c1, 0)
    ext_len = ext_len + torch.where(k >= 2, c2 << 8, 0)
    ext_len = ext_len + torch.where(k >= 3, c3 << 16, 0)
    ext_len = ext_len + P.select((k >= 4) & (c4 > 0), _TOO_BIG, 0)
    lit_len = torch.where(lf < 60, lf + 1, ext_len + 1)
    lit_hdr = torch.where(lf < 60, 1, 1 + k)

    copy1_len = ((c0 >> 2) & 7) + C.MIN_MATCH_LEN
    copy1_off = ((c0 >> 5) << 8) | c1
    copy2_len = lf + 1
    copy2_off = c1 | (c2 << 8)
    copy4_off = c1 | (c2 << 8) | (c3 << 16)
    copy4_off = copy4_off + P.select(c4 > 0, _TOO_BIG, 0)

    is_lit = kind == C.ElementType.LITERAL
    is_copy1 = kind == C.ElementType.COPY_1_BYTE_OFFSET
    is_copy2 = kind == C.ElementType.COPY_2_BYTE_OFFSET

    out_len = torch.where(is_lit, lit_len, torch.where(is_copy1, copy1_len, copy2_len))  # copy2/copy4 share lf+1
    offset = torch.where(
        is_lit, 0, torch.where(is_copy1, copy1_off, torch.where(is_copy2, copy2_off, copy4_off))
    )
    hdr = torch.where(is_lit, lit_hdr, torch.where(is_copy1, 2, P.select(is_copy2, 3, 5)))
    advance = hdr + torch.where(is_lit, lit_len, 0)

    return {
        "is_lit": is_lit,
        "out_len": out_len,
        "offset": offset,
        "advance": advance,
        "lit_data_start": torch.arange(cap, dtype=torch.int32, device=comp_i32.device) + lit_hdr,
    }


def decode_blocks(
    comp: torch.Tensor,
    comp_len: torch.Tensor,
    out_len: torch.Tensor,
    *,
    block_size: int = C.DEFAULT_BLOCK_SIZE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode a batch of independent blocks on the inputs' device.

    comp uint8[nb, cap], comp_len int32[nb], out_len int32[nb]; a
    ``comp_len`` outside [0, cap] is clamped into it (the runtime refuses
    such a frame before the decode; the reference's gathers would read
    fill values there).
    Returns ``(out, err)``: ``out`` uint8[nb, block_size] (zero past each
    block's ``out_len``) and ``err`` int32 flags per block (0 = ok), equal
    to the reference's ``decode_blocks`` on the same inputs. As there, the
    speculative tags read up to 4 bytes past a tag, so bytes at or past a
    block's ``comp_len`` can move the error bits and bytes of a block that
    fails its checks (never its verdict, nor a valid block's bytes).
    """
    hopper_decode._check_inputs(comp, comp_len, out_len, block_size)
    if comp.shape[1] == 0:
        raise ValueError("comp must have a positive cap")
    dev = comp.device
    nb, cap = comp.shape
    max_elems = cap // 2 + 2  # every element consumes >= 2 compressed bytes
    comp_len = comp_len.clamp(0, cap)[:, None]
    out_len = out_len[:, None]

    col = torch.arange(cap + 4, dtype=torch.int32, device=dev)
    comp_i32 = torch.nn.functional.pad(comp, (0, 4)).to(torch.int32)
    d = _speculative_tags(comp_i32, cap)

    # Successor over [0, cap]: node comp_len self-loops as the terminal.
    pos_idx = col[: cap + 1]
    adv = torch.nn.functional.pad(d["advance"], (0, 1))
    nxt = torch.minimum(pos_idx + adv, comp_len)
    nxt = torch.where(pos_idx >= comp_len, comp_len, nxt)

    # True tag positions = orbit of 0.
    elem_pos = P.orbit_positions(nxt, max_elems)
    del nxt, adv
    elem_valid = elem_pos < comp_len

    idx = elem_pos.clamp(0, cap - 1).long()

    def gather(a):
        return torch.gather(a, -1, idx)

    e_outlen = torch.where(elem_valid, gather(d["out_len"]), 0)
    e_islit = gather(d["is_lit"]) & elem_valid
    e_off = gather(d["offset"])
    e_lit_start = gather(d["lit_data_start"])
    e_adv = torch.where(elem_valid, gather(d["advance"]), 0)
    del d, idx

    e_start = P.exclusive_cumsum(e_outlen)
    total = e_start[:, -1:] + e_outlen[:, -1:]

    err = P.select(total != out_len, ERR_LENGTH_MISMATCH, 0)
    bad_off = elem_valid & ~e_islit & ((e_off <= 0) | (e_start - e_off < 0))
    err = err | P.select(bad_off.any(dim=-1, keepdim=True), ERR_BAD_OFFSET, 0)
    overrun = elem_valid & (elem_pos + e_adv > comp_len)
    err = err | P.select(overrun.any(dim=-1, keepdim=True), ERR_ELEMENT_OVERRUN, 0)
    del bad_off, overrun, e_adv, elem_valid, elem_pos

    # Map each output byte to its covering element, then to a source pointer.
    cov = P.covering_element(e_start, block_size).long()
    i_idx = torch.arange(block_size, dtype=torch.int32, device=dev)
    cov_start = torch.gather(e_start, -1, cov)
    cov_islit = torch.gather(e_islit, -1, cov)
    cov_off = torch.gather(e_off, -1, cov)
    cov_lit = torch.gather(e_lit_start, -1, cov)
    del cov

    lit_src = -(cov_lit + (i_idx - cov_start)) - 1
    copy_src = i_idx - torch.clamp_min(cov_off, 0)
    src = torch.where(cov_islit, lit_src, copy_src)
    src = torch.where(i_idx < total, src, -1)
    del lit_src, copy_src, cov_start, cov_islit, cov_off, cov_lit

    src = P.resolve_copy_chains(src, P.ceil_log2(block_size))

    out = P.take(comp_i32, (-src - 1).clamp(0, cap - 1))
    out = torch.where(i_idx < out_len, out, 0).to(torch.uint8)
    return out, err[:, 0]
