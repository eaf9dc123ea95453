"""Host orchestration for the decode path: frame scan and blockize.

Ported from ``pim_compression_tpu.runtime.pipeline`` (``scan_frames``,
``blockize_compressed``) and ``pim_compression_tpu.ops.decode``
(``padded_capacity``), which cannot be imported without JAX. The native C++
helpers run when the library is built; otherwise a vectorized numpy path.

One repair against the reference: the frame scan rejects a declared block
size outside ``(0, MAX_BLOCK_SIZE]`` on every path. The reference's oracle
scan (``oracle.scan_block_frames``) does not check it, and a huge declared
size would drive the padded allocations below.
"""

from __future__ import annotations

import numpy as np

from pim_compression_tpu import native
from pim_compression_tpu.format import constants as C
from pim_compression_tpu.format import oracle
from pim_compression_tpu.utils.errors import SnappyError, SnappyStatus


def padded_capacity(block_size: int) -> int:
    """Static per-block compressed capacity (worst case, 128-byte aligned)."""
    cap = C.max_compressed_length(block_size)
    return (cap + 127) // 128 * 128


def scan_frames(stream: bytes) -> dict:
    """Frame pre-pass: native C++ scan when available, oracle otherwise.

    Returns total_len, block_size and per-block numpy arrays payload_off,
    payload_size, out_off, out_size.
    """
    if native.available():
        info = native.scan_frames(stream)
    else:
        total, block_size, frames = oracle.scan_block_frames(stream)
        n = len(frames)
        # The native scan's checks, which the oracle walk leaves out: every
        # payload lies inside the stream and the frames cover total bytes.
        if any(off + size > len(stream) for off, size in frames) or block_size * n < total:
            raise SnappyError(SnappyStatus.INVALID_INPUT, "frames do not cover the stream")
        info = {
            "total_len": total,
            "block_size": block_size,
            "payload_off": np.array([f[0] for f in frames], dtype=np.int64),
            "payload_size": np.array([f[1] for f in frames], dtype=np.uint32),
            "out_off": np.arange(n, dtype=np.int64) * block_size,
            "out_size": np.minimum(
                block_size, total - block_size * np.arange(n, dtype=np.int64)
            ).astype(np.uint32),
        }
    if not 0 < info["block_size"] <= C.MAX_BLOCK_SIZE:
        raise SnappyError(
            SnappyStatus.INVALID_INPUT,
            f"declared block size {info['block_size']} outside "
            f"(0, {C.MAX_BLOCK_SIZE}]",
        )
    return info


def blockize_compressed(
    stream: bytes, info: dict
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack framed payloads into ``[num_blocks, cap]`` slots.

    Returns (comp uint8[nb, cap], comp_len int32[nb], out_len int32[nb]).
    Slot bytes at or past a block's ``comp_len`` are left unset on the
    native path: every decoder reads only below ``comp_len``.
    """
    cap = padded_capacity(info["block_size"])
    nb = len(info["payload_off"])
    sizes = np.asarray(info["payload_size"]).astype(np.int64)
    if nb and int(sizes.max()) > cap:
        raise SnappyError(SnappyStatus.INVALID_INPUT, "block exceeds capacity bound")
    if nb and native.available():
        comp = np.empty((nb, cap), dtype=np.uint8)
        native.blockize_compressed(stream, info["payload_off"], info["payload_size"], comp)
    else:
        comp = np.zeros((nb, cap), dtype=np.uint8)
        if nb:
            # One fancy-indexed copy of all payloads.
            raw = np.frombuffer(stream, dtype=np.uint8)
            total = int(sizes.sum())
            starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            within = np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)
            src = np.repeat(np.asarray(info["payload_off"], np.int64), sizes) + within
            rows = np.repeat(np.arange(nb, dtype=np.int64), sizes)
            comp[rows, within] = raw[src]
    comp_len = sizes.astype(np.int32)
    out_len = np.asarray(info["out_size"]).astype(np.int32)
    return comp, comp_len, out_len
