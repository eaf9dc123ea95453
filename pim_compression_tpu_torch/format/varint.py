"""Varint32 encode/decode (7-bit little-endian groups, MSB = continuation).

Reference semantics: writer ``snappy_compress.c:69-98``; reader
``snappy_decompress.c:23-37`` (at most 5 bytes, error past that).
"""

from __future__ import annotations

MAX_VARINT32_BYTES = 5


def encode_varint32(value: int) -> bytes:
    if value < 0 or value > 0xFFFFFFFF:
        raise ValueError(f"varint32 out of range: {value}")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint32(buf, pos: int = 0) -> tuple[int, int]:
    """Decode a varint32 at ``buf[pos:]``; returns (value, new_pos).

    Raises ValueError on truncation or a varint longer than 5 bytes,
    matching the reference's bounded reader.
    """
    value = 0
    shift = 0
    for i in range(MAX_VARINT32_BYTES):
        if pos + i >= len(buf):
            raise ValueError("truncated varint32")
        b = buf[pos + i]
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value & 0xFFFFFFFF, pos + i + 1
        shift += 7
    raise ValueError("varint32 longer than 5 bytes")


def read_varint32_stream(f) -> int:
    """Decode a varint32 from a binary file object at its current position.

    Same bounds as :func:`decode_varint32`; reads exactly the varint's bytes
    so callers can keep seek-walking the stream without buffering it.
    """
    value = 0
    shift = 0
    for _ in range(MAX_VARINT32_BYTES):
        b = f.read(1)
        if not b:
            raise ValueError("truncated varint32")
        value |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            return value & 0xFFFFFFFF
        shift += 7
    raise ValueError("varint32 longer than 5 bytes")
