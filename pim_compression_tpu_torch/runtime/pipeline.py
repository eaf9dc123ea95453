"""Host orchestration: frame scan and blockize for decode; blockize, triage,
raw frames and assembly for encode.

Ported from ``pim_compression_tpu.runtime.pipeline`` (``scan_frames``,
``blockize_compressed``, ``blockize_plain``, ``triage_incompressible``,
``raw_literal_frames``, ``assemble_compressed``) and
``pim_compression_tpu.ops.decode`` (``padded_capacity``), which cannot be
imported without JAX. The native C++ helpers run when the library is built;
otherwise a vectorized numpy path.

Repairs against the reference: the frame scan rejects a declared block
size outside ``(0, MAX_BLOCK_SIZE]`` on every path (the reference's oracle
scan, ``oracle.scan_block_frames``, does not check it, and a huge declared
size would drive the padded allocations below); ``raw_literal_frames`` is
vectorized where the reference loops over blocks in Python.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.format import constants as C
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.format.varint import encode_varint32
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus


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


def blockize_plain(data: bytes, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Cut plain input into ``[num_blocks, block_size]`` slots.

    Returns (blocks uint8[nb, block_size], lens int32[nb]). Slot bytes at or
    past a block's length are zero on every path: the match finder's hashes
    of a partial block's last positions read them, so stale bytes would
    change which candidate wins and with it the stream.
    """
    nb = -(-len(data) // block_size)
    lens = np.minimum(block_size, len(data) - block_size * np.arange(nb, dtype=np.int64)).astype(np.int32)
    if nb and native.available():
        # One parallel memcpy per block; every byte no block covers is zeroed
        # (the dirty watermark spans the whole fresh matrix).
        blocks = np.empty((nb, block_size), dtype=np.uint8)
        off = np.arange(nb, dtype=np.int64) * block_size
        native.blockize_compressed(data, off, lens.astype(np.uint32), blocks, nb * block_size)
        return blocks, lens
    raw = np.frombuffer(data, dtype=np.uint8)
    blocks = np.zeros((nb, block_size), dtype=np.uint8)
    full = len(data) // block_size
    blocks[:full] = raw[: full * block_size].reshape(full, block_size)
    if nb > full:
        blocks[full, : len(raw) - full * block_size] = raw[full * block_size :]
    return blocks, lens


def triage_incompressible(blocks: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Blocks to divert to raw literal frames (bool mask [num_blocks]).

    The reference's test, unchanged, so the same blocks are diverted: a full
    block whose sampled 4-grams (stride 8, stride 7 from byte 3, and the first
    2 KB contiguously) hold no duplicate within any sample set, and whose
    byte entropy over a ~2 K sample, with the Miller-Madow correction,
    exceeds 7.9 bits. Partial blocks always keep the device path. The test
    is per block, so chunks of rows run on a thread pool: numpy releases the
    GIL in the gram builds and sorts that dominate it.
    """
    nb = blocks.shape[0]
    chunk = 64
    if nb <= chunk:
        return _triage_rows(blocks, lens)
    starts = range(0, nb, chunk)
    with concurrent.futures.ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1)) as pool:
        parts = pool.map(lambda i: _triage_rows(blocks[i : i + chunk], lens[i : i + chunk]), starts)
        return np.concatenate(list(parts))


def _triage_rows(blocks: np.ndarray, lens: np.ndarray) -> np.ndarray:
    nb, bs = blocks.shape
    if nb == 0 or bs < 64:
        return np.zeros(nb, dtype=bool)

    def gram(start, stop, step):
        g = blocks[:, start:stop:step].astype(np.uint32)
        for b in (1, 2, 3):
            g |= blocks[:, start + b : stop + b : step].astype(np.uint32) << (8 * b)
        return g

    def has_dup(g):
        g.sort(axis=1)
        return (g[:, 1:] == g[:, :-1]).any(axis=1)

    dup = (
        has_dup(gram(0, bs - 3, 8))
        | has_dup(gram(3, bs - 3, 7))
        | has_dup(gram(0, min(2048, bs - 3), 1))
    )
    cand = np.flatnonzero((lens == bs) & ~dup)
    out = np.zeros(nb, dtype=bool)
    if cand.size == 0:
        return out
    sample = blocks[cand, :: max(1, bs // 2048)]
    n = sample.shape[1]
    keys = (np.arange(cand.size, dtype=np.int64)[:, None] << 8) | sample.astype(np.int64)
    hist = np.bincount(keys.ravel(), minlength=cand.size << 8).reshape(cand.size, 256)
    p = hist / n
    with np.errstate(divide="ignore", invalid="ignore"):
        ent = -np.nansum(np.where(p > 0, p * np.log2(p), 0.0), axis=1)
    ent = ent + ((hist > 0).sum(axis=1) - 1) / (2 * n * np.log(2))
    out[cand] = ent > 7.9
    return out


def raw_literal_frames(
    blocks: np.ndarray, lens: np.ndarray, comp: np.ndarray, sizes: np.ndarray, idx: np.ndarray
) -> None:
    """Fill the ``comp``/``sizes`` rows ``idx`` with one literal element each:
    a tag, 0-3 little-endian length bytes and the block's bytes (an empty
    block gets size 0). The same bytes as the reference's per-block loop,
    written with one scatter per header length."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return
    bs = blocks.shape[1]
    n = lens[idx].astype(np.int64)
    l1 = np.maximum(n - 1, 0)
    hlen = np.where(l1 < 60, 1, np.where(l1 < 1 << 8, 2, np.where(l1 < 1 << 16, 3, 4)))
    comp[idx, 0] = np.where(hlen == 1, l1 << 2, (58 + hlen) << 2)
    for j in (1, 2, 3):
        more = hlen > j
        comp[idx[more], j] = (l1[more] >> (8 * (j - 1))) & 0xFF
    for h in np.unique(hlen):
        rows = idx[hlen == h]
        comp[rows, h : h + bs] = blocks[rows]  # bytes past lens are zero and past the size
    sizes[idx] = np.where(n == 0, 0, hlen + n)


def assemble_compressed(
    comp: np.ndarray, sizes: np.ndarray, total_len: int, block_size: int
) -> bytes | bytearray:
    """The framed stream: header varints, then per block a u32 size and its
    ``sizes[i]`` payload bytes from ``comp[i]``. Native parallel copy when
    built (returns the bytearray it filled), else one numpy scatter."""
    nb = len(sizes)
    sizes = np.asarray(sizes, dtype=np.int64)
    header = encode_varint32(total_len) + encode_varint32(block_size)
    if nb and native.available():
        return native.assemble_compressed(np.ascontiguousarray(comp[:nb], dtype=np.uint8), sizes, header)
    frame_sizes = sizes + C.BLOCK_FRAME_BYTES
    offsets = len(header) + np.concatenate([[0], np.cumsum(frame_sizes)])
    out = np.zeros(int(offsets[-1]), dtype=np.uint8)
    out[: len(header)] = np.frombuffer(header, dtype=np.uint8)
    for b in range(4):
        out[offsets[:-1] + b] = (sizes >> (8 * b)) & 0xFF
    if nb:
        total = int(sizes.sum())
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)
        rows = np.repeat(np.arange(nb, dtype=np.int64), sizes)
        dst = np.repeat(offsets[:-1] + C.BLOCK_FRAME_BYTES, sizes) + within
        out[dst] = comp[rows, within]
    return out.tobytes()
