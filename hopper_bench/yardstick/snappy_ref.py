"""A plain Snappy block codec in Python: the reference the comparison uses.

Written for this benchmark from the format's definition (the element
layout of ``pim_compression_tpu_torch/format/constants.py`` at commit
71cf44af88e2ee9ebbcc411566b7e4a08f8328ee, which follows the upstream
``snappy/dpu_snappy.h``); it imports nothing of the program. A block is a
bare element stream, without a length preamble: the framing carries each
block's compressed size, and its plaintext length is the block size, or
less for the last block.

``decode_block`` is the reference decoder. ``encode_block`` is a greedy
encoder with a table of 4-byte words; it serves the tests and, with
``verify=False``, the compress cells' control (see ``PERF.md``). Both
take flags only the controls set: ``overlap=False`` copies an element
whose offset is below its length from a snapshot of what was written,
which breaks run-length copies; ``verify=False`` emits a copy on an equal
hash without comparing the words.
"""

from __future__ import annotations

import hashlib

import numpy as np


class BlockError(ValueError):
    """A stream that is not a valid block of the given plaintext length."""


def decode_block(comp: bytes, out_len: int, overlap: bool = True) -> bytes:
    """The plaintext of one block's element stream ``comp``; raises
    ``BlockError`` unless the stream ends exactly at its last element and
    yields exactly ``out_len`` bytes."""
    out = bytearray()
    p, n = 0, len(comp)
    while p < n:
        tag = comp[p]
        kind = tag & 3
        p += 1
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                if p + extra > n:
                    raise BlockError("literal length past the end")
                length = int.from_bytes(comp[p : p + extra], "little")
                p += extra
            length += 1
            if p + length > n:
                raise BlockError("literal past the end")
            out += comp[p : p + length]
            p += length
            continue
        if kind == 1:
            if p + 1 > n:
                raise BlockError("offset past the end")
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | comp[p]
            p += 1
        else:
            width = 2 if kind == 2 else 4
            if p + width > n:
                raise BlockError("offset past the end")
            length = (tag >> 2) + 1
            offset = int.from_bytes(comp[p : p + width], "little")
            p += width
        at = len(out)
        if offset == 0 or offset > at:
            raise BlockError(f"offset {offset} at {at}")
        if offset >= length:
            out += out[at - offset : at - offset + length]
        elif overlap:
            out += (out[at - offset :] * (length // offset + 1))[:length]
        else:
            out += out[at - offset :] + bytes(length - offset)
        if len(out) > out_len:
            raise BlockError("output past the block")
    if len(out) != out_len:
        raise BlockError(f"{len(out)} bytes, not {out_len}")
    return bytes(out)


def _literal(out: bytearray, data: bytes, start: int, end: int) -> None:
    while start < end:
        n = min(end - start, 65536)
        if n <= 60:
            out.append((n - 1) << 2)
        elif n <= 256:
            out += bytes((60 << 2, n - 1))
        else:
            out += bytes((61 << 2, (n - 1) & 0xFF, (n - 1) >> 8))
        out += data[start : start + n]
        start += n


def _copy(out: bytearray, offset: int, length: int) -> None:
    while length > 0:
        n = 64 if length >= 68 else 60 if length > 64 else length
        if 4 <= n <= 11 and offset < 2048:
            out += bytes((1 | ((n - 4) << 2) | ((offset >> 8) << 5), offset & 0xFF))
        else:
            out += bytes((2 | ((n - 1) << 2), offset & 0xFF, offset >> 8))
        length -= n


def encode_block(data: bytes, key_bits: int | None = None, verify: bool = True) -> bytes:
    """A greedy element stream of ``data`` (at most 65536 bytes): at each
    position the last earlier position with the same 4-byte word (or, with
    ``key_bits``, the same ``key_bits``-bit hash of it) within 65535 bytes
    is the candidate; an equal word starts a copy, extended byte by byte.
    With ``verify=False`` an equal hash starts a copy of at least 4 bytes
    unchecked, so a hash collision corrupts the block."""
    n = len(data)
    out = bytearray()
    table: dict = {}
    lit = i = 0
    while i + 4 <= n:
        word = data[i : i + 4]
        key = word if key_bits is None else (
            (int.from_bytes(word, "little") * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - key_bits)
        cand = table.get(key)
        table[key] = i
        if cand is None or i - cand > 65535 or (verify and data[cand : cand + 4] != word):
            i += 1
            continue
        m = 4
        while i + m + 8 <= n and data[cand + m : cand + m + 8] == data[i + m : i + m + 8]:
            m += 8
        while i + m < n and data[cand + m] == data[i + m]:
            m += 1
        _literal(out, data, lit, i)
        _copy(out, i - cand, m)
        i += m
        lit = i
    _literal(out, data, lit, n)
    return bytes(out)


def digest(block: bytes) -> bytes:
    return hashlib.blake2b(block, digest_size=16).digest()


def check_blocks(task: tuple) -> list[int]:
    """Pool task: ``(comps, out_lens, digests)``; the indices of the blocks
    whose stream does not decode to a plaintext of that digest."""
    comps, out_lens, digests = task
    bad = []
    for k, (comp, out_len, want) in enumerate(zip(comps, out_lens, digests)):
        try:
            ok = digest(decode_block(comp, out_len)) == want
        except BlockError:
            ok = False
        if not ok:
            bad.append(k)
    return bad


def decode_task(task: tuple) -> list[bytes]:
    """Pool task of the decompress control: ``(comps, out_lens, overlap)``;
    each block's plaintext, or zeros where the stream fails to decode."""
    comps, out_lens, overlap = task
    outs = []
    for comp, out_len in zip(comps, out_lens):
        try:
            outs.append(decode_block(comp, out_len, overlap))
        except BlockError:
            outs.append(bytes(out_len))
    return outs


def encode_task(task: tuple) -> list[bytes]:
    """Pool task of the compress control: ``(blocks, key_bits, verify)``."""
    blocks, key_bits, verify = task
    return [encode_block(b, key_bits, verify) for b in blocks]


def varint_len(value: int) -> int:
    """Bytes of ``value`` as a varint32."""
    return max(1, (value.bit_length() + 6) // 7)


def framed_bytes(plain_bytes: int, block_size: int, sizes_sum: int, blocks: int) -> int:
    """Bytes of the framed stream of ``blocks`` blocks: two header varints
    (plaintext length, block size), then each block's u32 size and data."""
    return varint_len(plain_bytes) + varint_len(block_size) + 4 * blocks + sizes_sum


def rows_to_bytes(rows: np.ndarray, lengths) -> list[bytes]:
    """Each row of a uint8 matrix cut to its length, as bytes."""
    return [rows[k, : int(n)].tobytes() for k, n in enumerate(lengths)]
