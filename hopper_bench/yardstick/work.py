"""The bytes a codec function must move, and the least time the card needs.

The byte arithmetic of ``pim_compression_tpu_torch/scripts/work_ledger.py``
at commit 71cf44af88e2ee9ebbcc411566b7e4a08f8328ee (``HBM_BYTES_PER_S``,
``bound`` and ``decode_work``'s rule: each input read once, each output
written once), frozen here and counted per function, not per kernel: what
the decode or the encode of a batch must read and write whatever kernels
compute it. So a later kernel that reads packed rows, or a fused match and
emit, is held to the same work, and no share can pass 100 %.

- decode of a batch: each block's compressed bytes (``comp_len``) and both
  lengths read, its plaintext (``out_len``) and its verdict written;
- encode of a batch: each block's plaintext (``lens``) and its length read,
  its compressed bytes (``sizes``) and their length written.

No operation count enters a share: the ledger's 33.45e12 int32 ops/s is a
derived peak, not a datasheet one.
"""

from __future__ import annotations

# Device memory of one H100 SXM at its 700 W limit (NVIDIA's datasheet).
HBM_BYTES_PER_S = 3.35e12


def decode_bytes(comp_len_sum: int, out_len_sum: int, blocks: int) -> int:
    """Bytes the decode of ``blocks`` blocks must move: payloads and two
    int32 lengths read, plaintext and an int32 verdict written."""
    return comp_len_sum + out_len_sum + 12 * blocks


def encode_bytes(lens_sum: int, sizes_sum: int, blocks: int) -> int:
    """Bytes the encode of ``blocks`` blocks must move: plaintext and an
    int32 length read, compressed bytes and an int32 size written."""
    return lens_sum + sizes_sum + 8 * blocks


def least_seconds(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes`` once."""
    return nbytes / HBM_BYTES_PER_S


def roofline_percent(nbytes: int, device_seconds: float) -> float | None:
    """The least time over the time the kernels took, in %; None where no
    kernel time was read."""
    if device_seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * least_seconds(nbytes) / device_seconds
