"""Deterministic inputs for checking the codec: payloads, plain blocks for
the encoders, hand-built compressed blocks and mutants for the decoders.

Everything here is made from a seed, so the tests and ``chip_smoke.py``
feed the same bytes to every implementation they compare.
"""

from __future__ import annotations

import random

import numpy as np

from pim_compression_tpu_torch.format import constants as C
from pim_compression_tpu_torch.format.varint import encode_varint32


def text_payload(n: int, seed: int = 0) -> bytes:
    """``n`` bytes of text-like data: Zipf-distributed words from a seeded
    vocabulary, with near repeats (lag <= 4 KB), far repeats, byte runs and
    a few stretches of random bytes."""
    rng = np.random.default_rng(seed)
    vocab = 4096
    wlen = rng.integers(2, 12, vocab)
    woff = np.concatenate([[0], np.cumsum(wlen)])
    letters = rng.integers(97, 123, int(woff[-1]), dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    pos = 0
    while pos < n:
        m = min(int(rng.integers(256, 8192)), n - pos)
        r = rng.random()
        if r < 0.12 and pos >= 64:  # near repeat, possibly overlapping
            lag = int(rng.integers(1, min(pos, 4096) + 1))
            out[pos : pos + m] = np.resize(out[pos - lag : pos], m)
        elif r < 0.22 and pos >= m:  # far repeat
            src = int(rng.integers(0, pos - m + 1))
            out[pos : pos + m] = out[src : src + m]
        elif r < 0.27:  # byte runs
            run_len = rng.integers(1, 200, m // 8 + 1)
            out[pos : pos + m] = np.repeat(rng.integers(0, 256, run_len.size, dtype=np.uint8), run_len)[:m]
        elif r < 0.29:  # incompressible stretch
            out[pos : pos + m] = rng.integers(0, 256, m, dtype=np.uint8)
        else:  # words
            ids = (rng.zipf(1.3, m // 3 + 1) - 1) % vocab
            lens = wlen[ids] + 1  # word + separator
            ends = np.cumsum(lens)
            within = np.arange(int(ends[-1])) - np.repeat(ends - lens, lens)
            idx = np.repeat(woff[ids], lens) + within
            words = letters[np.minimum(idx, woff[-1] - 1)]  # a separator slot may index past the end
            words[ends - 1] = 32
            out[pos : pos + m] = np.resize(words, m)
        pos += m
    return out.tobytes()


def plain_blocks(block_size: int, num_blocks: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Blocks for checking encoders: (blocks uint8[n, block_size], lens
    int32[n]), zero past each length. About half are full, the rest take a
    random length; the bytes mix prefixes of one shared snippet (repeats at
    many lags) with random stretches."""
    rng = np.random.default_rng(seed)
    snippet = rng.integers(0, 256, 300, dtype=np.uint8)
    blocks = np.zeros((num_blocks, block_size), dtype=np.uint8)
    lens = np.zeros(num_blocks, dtype=np.int32)
    for i in range(num_blocks):
        parts, n = [], 0
        while n < block_size:
            if rng.random() < 0.6:
                part = snippet[: int(rng.integers(4, 121))]
            else:
                part = rng.integers(0, 256, int(rng.integers(3, 61)), dtype=np.uint8)
            parts.append(part)
            n += len(part)
        length = block_size if rng.random() < 0.5 else int(rng.integers(1, block_size + 1))
        blocks[i, :length] = np.concatenate(parts)[:length]
        lens[i] = length
    return blocks, lens


def hand_plain_blocks(block_size: int, seed: int = 0, far_lag: int = 8193) -> tuple[np.ndarray, np.ndarray]:
    """Edge cases for the encoders, as ``plain_blocks`` returns them: all
    zeros, one byte repeated, a partial block of 5 bytes, a block whose last
    20 bytes repeat an earlier stretch (the hashes of its last positions
    read past the block), a random block with one 32-byte repeat at lag
    ``far_lag`` (when it fits), and 4 random blocks (block_size >= 128)."""
    rng = np.random.default_rng(seed)
    rand = lambda: rng.integers(0, 256, block_size, dtype=np.uint8)  # noqa: E731
    rows = [np.zeros(block_size, np.uint8), np.full(block_size, 0x61, np.uint8)]
    lens = [block_size, block_size]
    partial = np.zeros(block_size, np.uint8)
    partial[:5] = rng.integers(0, 256, 5, dtype=np.uint8)
    rows.append(partial)
    lens.append(5)
    tail = rand()
    tail[-20:] = tail[50:70]
    rows.append(tail)
    lens.append(block_size)
    if far_lag + 42 <= block_size:
        far = rand()
        far[10 + far_lag : 42 + far_lag] = far[10:42]
        rows.append(far)
        lens.append(block_size)
    for _ in range(4):
        rows.append(rand())
        lens.append(block_size)
    return np.stack(rows), np.array(lens, dtype=np.int32)


def synthetic_matches(block_size: int, seed: int = 0) -> tuple[np.ndarray, ...]:
    """Matcher-shaped inputs for checking the emit alone: (blocks uint8[7,
    block_size], lens int32[7], mlen uint8[7, block_size], mlag int16[7,
    block_size]). Random bytes; lengths in {0} u [4, 64] at densities from
    sparse (literal runs of thousands of bytes) to dense, with a row of
    64-byte copies from every 64th position; lags over all 16 bits (an
    int16's bits, read unsigned); one ``lens`` of 0, others below
    ``block_size`` with lengths and bytes past them, and each row's last
    position reached by a literal stretch with length 4 there, so that the
    lazy-1 lookahead past ``lens`` (length 5) and at ``block_size`` (the
    next row's first length, 64) decides its output. 7 rows: not a
    multiple of a few warps."""
    rng = np.random.default_rng(seed)
    nb = 7
    blocks = rng.integers(0, 256, (nb, block_size), dtype=np.uint8)
    density = np.array([0.0005, 0.004, 0.05, 0.3, 0.6, 0.9, 0.2])[:, None]
    mlen = np.where(rng.random((nb, block_size)) < density, rng.integers(4, 65, (nb, block_size)), 0)
    mlen = mlen.astype(np.uint8)
    mlen[5, ::64] = 64
    mlag = rng.integers(0, 1 << 16, (nb, block_size)).astype(np.uint16).view(np.int16)
    lens = np.array([block_size, block_size - 1, block_size - 37, 0, block_size, block_size,
                     max(1, block_size // 3 - 1)], np.int32)
    # Each row's last position takes length 4 after a literal stretch, so
    # the walk reaches it and its lazy-1 lookahead decides the output: past
    # lens a length of 5 defers it; at block_size the next row's first
    # length (64) must read as 0.
    for b in (0, 1, 2, 6):
        n = int(lens[b])
        mlen[b, max(0, n - 70) : n - 1] = 0
        mlen[b, n - 1] = 4
        if n < block_size:
            mlen[b, n] = 5
    mlen[1, 0] = 64
    return blocks, lens, mlen, mlag


def sweep_edge_blocks(block_size: int, window: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Edge cases for the sweep matcher, as ``plain_blocks`` returns them:
    random blocks with a 100-byte repeat at lag 1 (a byte run), at lag
    ``window`` (the fine sweep's last lag), at ``window + 1`` (the first lag
    only a coarse search reaches) and at 1237 (unaligned, not a multiple of
    8), each where it fits; a block whose last 70 bytes repeat at lag 40 up
    to its length (a run cut at ``len``); and a block 3 bytes short of
    ``block_size`` with its copy running into the cut."""
    rng = np.random.default_rng(seed)
    rows, lens = [], []
    for lag in (1, window, window + 1, 1237):
        if 0 < lag and lag + 120 <= block_size:
            row = rng.integers(0, 256, block_size, dtype=np.uint8)
            start = min(lag + 17, block_size - 100)
            for p in range(start, start + 100):  # overlapping copies allowed
                row[p] = row[p - lag]
            rows.append(row)
            lens.append(block_size)
    for short in (0, 3):
        row = rng.integers(0, 256, block_size, dtype=np.uint8)
        n = block_size - short
        for p in range(n - 70, n):
            row[p] = row[p - 40]
        row[n:] = 0
        rows.append(row)
        lens.append(n)
    return np.stack(rows), np.array(lens, dtype=np.int32)


def sweep_hard_blocks(block_size: int, window: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Blocks that stress the sweep kernel's table of word occurrences, as
    ``plain_blocks`` returns them: one 4-byte word repeated through the
    block (every walk ends at its first entry); all zeros; random bytes
    with one word at every 8-aligned position (each aligned position's
    chain is every earlier one, its run 1 word) and 40-byte repeats at lags
    ``window + 64`` and ``window + 13`` (past the fine reach, aligned and
    not) where they fit; random bytes over two letters, 5 bytes short of
    ``block_size`` (chains of a sixteenth of the earlier positions, no run
    reaching 64 bytes); and 4-byte slots drawn from 64 words whose keys in
    the kernel's table are all equal (key collisions at every 4-aligned
    position)."""
    from pim_compression_tpu_torch.utils import sweep_table

    rng = np.random.default_rng(seed)
    rows = [np.resize(np.frombuffer(b"abcd", np.uint8), block_size), np.zeros(block_size, np.uint8)]
    lens = [block_size, block_size]
    stride8 = rng.integers(0, 256, block_size, dtype=np.uint8)
    stride8[: block_size // 8 * 8].reshape(-1, 8)[:, :4] = (0x11, 0x22, 0x33, 0x44)
    for lag, at in ((window + 64, block_size // 2 + 3), (window + 13, block_size // 2 + 203)):
        if 0 <= at - lag and at + 40 <= block_size:
            stride8[at : at + 40] = stride8[at - lag : at - lag + 40]
    rows.append(stride8)
    lens.append(block_size)
    rows.append(rng.choice(np.frombuffer(b"ab", np.uint8), block_size))
    lens.append(max(0, block_size - 5))
    # Words v with the same top key bits of v * kHashMul: the multiplier is
    # odd, so v = h * inverse(kHashMul) for h of one key and 64 low parts.
    low_bits = 32 - sweep_table.KEY_BITS
    key = int(rng.integers(0, 1 << sweep_table.KEY_BITS))
    low = rng.choice(1 << low_bits, 64, replace=False)
    inverse = pow(sweep_table.HASH_MUL, -1, 1 << 32)
    colliding = np.array([((key << low_bits | int(x)) * inverse) % (1 << 32) for x in low], "<u4")
    slots = colliding[rng.integers(0, 64, -(-block_size // 4))]
    rows.append(slots.view(np.uint8)[:block_size])
    lens.append(block_size)
    blocks = np.stack(rows)
    blocks[3, lens[3] :] = 0
    return blocks, np.array(lens, dtype=np.int32)


def far_repeat_block(block_size: int, seed: int = 0) -> bytes:
    """A block of random bytes whose last 7/16 repeat its first bytes at lag
    9/16 of the block: any compressor's copies there take offsets above
    32768 in a 64 KB block."""
    lag = block_size * 9 // 16
    head = np.random.default_rng(seed).integers(0, 256, lag, dtype=np.uint8).tobytes()
    return head + head[: block_size - lag]


def frame_block(payload: bytes, out_len: int, block_size: int) -> bytes:
    """A one-block framed stream: header varints, u32 size, payload."""
    return (
        encode_varint32(out_len)
        + encode_varint32(block_size)
        + len(payload).to_bytes(C.BLOCK_FRAME_BYTES, "little")
        + payload
    )


def _literal(data: bytes, ext_bytes: int = 0) -> bytes:
    """A literal element; ``ext_bytes`` 1-4 forces that many length bytes."""
    n = len(data) - 1
    if not ext_bytes:
        return bytes([n << 2]) + data if n < 60 else _literal(data, (n.bit_length() + 7) // 8)
    return bytes([(59 + ext_bytes) << 2]) + n.to_bytes(ext_bytes, "little") + data


def _copy(offset: int, length: int, width: int) -> bytes:
    """A copy element with a 1-, 2- or 4-byte offset."""
    if width == 1:
        return bytes([1 | ((length - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF])
    kind = 2 if width == 2 else 3
    return bytes([kind | ((length - 1) << 2)]) + offset.to_bytes(width, "little")


def hand_blocks(block_size: int) -> list[tuple[bytes, int]]:
    """Valid hand-built blocks (payload, out_len) for a block size >= 256:
    COPY_4, literal headers with 1-4 length bytes, overlapping run copies at
    offsets 1, 2 and 3, and a copy at the largest offset the block allows."""
    blocks = [
        (_literal(b"ABCDE") + _copy(5, 3, 4), 8),  # COPY_4
        (_literal(b"Q") + _copy(1, 64, 4) + _copy(65, 64, 2), 129),
    ]
    for ext in (1, 2, 3, 4):
        data = bytes(range(ext * 40, ext * 40 + 70))
        blocks.append((_literal(data, ext) + _copy(70, 11, 1) + _literal(data[:9], ext), 90))
    for off in (1, 2, 3):
        seed = b"xyz"[:off]
        blocks.append((_literal(seed) + _copy(off, 64, 2) + _copy(off, 11, 1) + _copy(off, 40, 4), off + 115))
    head = bytes((i * 7 + 3) & 0xFF for i in range(block_size - 1))
    for width in (2, 4):  # the last byte copies the first: offset block_size - 1
        blocks.append((_literal(head) + _copy(block_size - 1, 1, width), block_size))
    return blocks


def _elements(payload: bytes) -> list[tuple[int, int, int]]:
    """(position, kind, output position) of each element of a valid payload."""
    out, p, o = [], 0, 0
    while p < len(payload):
        tag = payload[p]
        kind = tag & 3
        out.append((p, kind, o))
        if kind == 0:
            lf = tag >> 2
            n = lf - 59 if lf >= 60 else 0
            length = (int.from_bytes(payload[p + 1 : p + 1 + n], "little") if n else lf) + 1
            p += 1 + n + length
        else:
            length = ((tag >> 2) & 7) + 4 if kind == 1 else (tag >> 2) + 1
            p += 1 + (1, 2, 4)[kind - 1]
        o += length
    return out


def block_mutants(
    blocks: list[tuple[bytes, int]], rng: random.Random, n: int, block_size: int
) -> list[tuple[bytes, int]]:
    """``n`` malformed variants of valid blocks: truncations, flipped tag
    bits, offset 0, offsets past the output, over-long literals and wrong
    out_len (kept in [1, block_size]). A mutant may still happen to be valid."""
    mutants = []
    while len(mutants) < n:
        payload, out_len = blocks[rng.randrange(len(blocks))]
        b = bytearray(payload)
        elems = _elements(payload)
        copies = [e for e in elems if e[1] != 0]
        literals = [e for e in elems if e[1] == 0]
        what = rng.randrange(6)
        if what == 0:
            b = b[: rng.randrange(len(b))]
        elif what == 1:
            p = rng.choice(elems)[0]
            b[p] ^= 1 << rng.randrange(8)
        elif what in (2, 3) and copies:
            p, kind, o = rng.choice(copies)
            if what == 2:
                off = 0
            else:
                off = o + 1 + rng.randrange(64)
            if kind == 1:
                off = min(off, 2047)
                b[p] = (b[p] & 0x1F) | ((off >> 8) << 5)
                b[p + 1] = off & 0xFF
            else:
                width = 2 if kind == 2 else 4
                off = min(off, (1 << (8 * width)) - 1)  # past 65535 only at 64 KB blocks
                b[p + 1 : p + 1 + width] = off.to_bytes(width, "little")
        elif what == 4 and literals:
            p = rng.choice(literals)[0]
            lf = b[p] >> 2
            if lf < 60:
                b[p] = min(59, lf + 1 + rng.randrange(8)) << 2
            else:  # grow the first length byte
                b[p + 1] = min(255, b[p + 1] + 1 + rng.randrange(8))
        else:
            out_len = min(block_size, max(1, out_len + rng.choice((-3, -1, 1, 2, 64))))
        mutants.append((bytes(b), out_len))
    return mutants
