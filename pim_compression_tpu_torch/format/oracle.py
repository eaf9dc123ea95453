"""Pure-Python oracle codec for the block-parallel modified-Snappy format.

This is the framework's correctness arbiter (the role the reference's host
codec plays — ``snappy_compress.c:455-485`` / ``snappy_decompress.c:218-289``).
It is intentionally simple and sequential; the TPU kernels and the C++ native
codec are both validated against it, and it is itself validated bit-for-bit
against the corpus shipped with the reference (``test/*.snappy``).

The compressor reproduces the reference's exact emit rules and heuristics
(multiplicative hash 0x1e35a7bd with a 256..2^14-entry table, ``skip++ >> 5``
probe skipping, 15-byte trailing-literal margin, 68/64/60 copy chunking —
reference ``snappy_compress.c:284-413``) so its output is byte-identical to
the reference compressor's. The TPU encoder is free to use a different match
finder (precedent: the reference's DPU kernel uses a different hash,
``dpu-compress/dpu_compress.c:202-212``); only decoder semantics are the
format contract.
"""

from __future__ import annotations

from . import constants as C
from .varint import decode_varint32, encode_varint32


def _load32(buf: memoryview, i: int) -> int:
    return buf[i] | (buf[i + 1] << 8) | (buf[i + 2] << 16) | (buf[i + 3] << 24)


def _hash32(v: int, shift: int) -> int:
    return ((v * C.HASH_MULTIPLIER) & 0xFFFFFFFF) >> shift


def _table_entries(size_to_compress: int) -> int:
    entries = C.MIN_HASH_TABLE_ENTRIES
    while entries < (1 << C.MAX_HASH_TABLE_BITS) and entries < size_to_compress:
        entries <<= 1
    return entries


def _find_match_length(data: memoryview, s1: int, s2: int, s2_limit: int) -> int:
    matched = 0
    while s2 + 4 <= s2_limit and _load32(data, s2) == _load32(data, s1 + matched):
        s2 += 4
        matched += 4
    while s2 < s2_limit and data[s1 + matched] == data[s2]:
        s2 += 1
        matched += 1
    return matched


def _emit_literal(out: bytearray, data: memoryview, start: int, length: int) -> None:
    n = length - 1
    if n < C.LITERAL_MAX_INLINE_LEN:
        out.append(C.ElementType.LITERAL | (n << 2))
    else:
        count = 0
        length_bytes = bytearray()
        while n > 0:
            length_bytes.append(n & 0xFF)
            n >>= 8
            count += 1
        out.append(C.ElementType.LITERAL | ((59 + count) << 2))
        out.extend(length_bytes)
    out.extend(data[start : start + length])


def _emit_copy_upto64(out: bytearray, offset: int, length: int) -> None:
    if length < 12 and offset < C.COPY1_MAX_OFFSET:
        out.append(
            C.ElementType.COPY_1_BYTE_OFFSET
            | ((length - C.MIN_MATCH_LEN) << 2)
            | ((offset >> 8) << 5)
        )
        out.append(offset & 0xFF)
    else:
        out.append(C.ElementType.COPY_2_BYTE_OFFSET | ((length - 1) << 2))
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # 68/64/60 chunking rule (reference snappy_compress.c:254-272): keeps the
    # final chunk >= 4 bytes so it is always encodable.
    while length >= C.COPY_CHUNK_THRESHOLD:
        _emit_copy_upto64(out, offset, C.COPY_CHUNK_LEN)
        length -= C.COPY_CHUNK_LEN
    if length > C.MAX_COPY_LEN:
        _emit_copy_upto64(out, offset, C.COPY_PRE_REMAINDER_LEN)
        length -= C.COPY_PRE_REMAINDER_LEN
    _emit_copy_upto64(out, offset, length)


def compress_block(data: memoryview, base: int, size: int) -> bytes:
    """Compress one block; returns the compressed payload (no u32 frame).

    Faithful reimplementation of the reference hot loop
    (``snappy_compress.c:284-413``) in index arithmetic instead of pointers.
    """
    out = bytearray()
    entries = _table_entries(size)
    shift = 32 - entries.bit_length() + 1  # 32 - log2(entries)
    table = [0] * entries
    end = base + size
    next_emit = base
    curr = base

    if size >= C.INPUT_MARGIN_BYTES:
        limit = base + size - C.INPUT_MARGIN_BYTES
        curr += 1
        next_hash = _hash32(_load32(data, curr), shift)
        while True:
            # Step 1: probe for a 4-byte match, widening the stride every 32
            # missed probes (skip++ >> 5).
            skip_bytes = C.SKIP_INITIAL
            next_input = curr
            while True:
                curr = next_input
                hval = next_hash
                bytes_between = skip_bytes >> 5
                skip_bytes += 1
                next_input = curr + bytes_between
                if next_input > limit:
                    break
                next_hash = _hash32(_load32(data, next_input), shift)
                candidate = base + table[hval]
                table[hval] = curr - base
                if _load32(data, curr) == _load32(data, candidate):
                    break
            if next_input > limit:
                break  # emit remainder

            # Step 2: emit pending literal bytes before the match.
            _emit_literal(out, data, next_emit, curr - next_emit)

            # Step 3: chained copies; update table at tail-1 and tail after
            # each emitted copy to improve subsequent match finding.
            while True:
                match_base = curr
                matched = C.MIN_MATCH_LEN + _find_match_length(
                    data, candidate + C.MIN_MATCH_LEN, curr + C.MIN_MATCH_LEN, end
                )
                curr += matched
                _emit_copy(out, match_base - candidate, matched)
                insert_tail = curr - 1
                next_emit = curr
                if curr >= limit:
                    break
                prev_hash = _hash32(_load32(data, insert_tail), shift)
                table[prev_hash] = curr - base - 1
                curr_hash = _hash32(_load32(data, insert_tail + 1), shift)
                candidate = base + table[curr_hash]
                candidate_bytes = _load32(data, candidate)
                table[curr_hash] = curr - base
                if _load32(data, insert_tail + 1) != candidate_bytes:
                    break
            if curr >= limit:
                break  # emit remainder
            next_hash = _hash32(_load32(data, insert_tail + 2), shift)
            curr += 1

    if next_emit < end:
        _emit_literal(out, data, next_emit, end - next_emit)
    return bytes(out)


def compress(data: bytes, block_size: int = C.DEFAULT_BLOCK_SIZE) -> bytes:
    """Compress a whole buffer into the framed stream.

    Stream layout per reference ``snappy_compress.c:455-485``: varint total
    decompressed length, varint block size, then per block a u32 LE
    compressed-size frame followed by the compressed payload.
    """
    if not 0 < block_size <= C.MAX_BLOCK_SIZE:
        raise ValueError(f"block_size must be in (0, {C.MAX_BLOCK_SIZE}]")
    view = memoryview(data)
    out = bytearray()
    out.extend(encode_varint32(len(data)))
    out.extend(encode_varint32(block_size))
    pos = 0
    while pos < len(data):
        size = min(block_size, len(data) - pos)
        payload = compress_block(view, pos, size)
        out.extend(len(payload).to_bytes(C.BLOCK_FRAME_BYTES, "little"))
        out.extend(payload)
        pos += size
    return bytes(out)


def decompress_block(comp: memoryview, out: bytearray, block_start: int) -> None:
    """Decompress one block payload, appending to ``out``.

    ``block_start`` is the output index where this block begins; backreference
    validity is checked against it (per-block, matching the DPU decoder's
    per-region check, ``dpu-decompress/dpu_decompress.c:174-178`` — the
    compressor never emits cross-block references).
    """
    pos = 0
    n = len(comp)
    while pos < n:
        tag = comp[pos]
        pos += 1
        elem = tag & 0b11
        if elem == C.ElementType.LITERAL:
            lf = tag >> 2
            if lf < C.LITERAL_MAX_INLINE_LEN:
                length = lf + 1
            else:
                count = lf - 59
                if pos + count > n:
                    raise ValueError("truncated long-literal length")
                length = int.from_bytes(comp[pos : pos + count], "little") + 1
                pos += count
            if pos + length > n:
                raise ValueError("literal overruns block")
            out.extend(comp[pos : pos + length])
            pos += length
        else:
            if elem == C.ElementType.COPY_1_BYTE_OFFSET:
                length = ((tag >> 2) & 0x7) + C.MIN_MATCH_LEN
                if pos + 1 > n:
                    raise ValueError("truncated COPY_1 offset")
                offset = ((tag >> 5) << 8) | comp[pos]
                pos += 1
            elif elem == C.ElementType.COPY_2_BYTE_OFFSET:
                length = ((tag >> 2) & 0x3F) + 1
                if pos + 2 > n:
                    raise ValueError("truncated COPY_2 offset")
                offset = int.from_bytes(comp[pos : pos + 2], "little")
                pos += 2
            else:
                length = ((tag >> 2) & 0x3F) + 1
                if pos + 4 > n:
                    raise ValueError("truncated COPY_4 offset")
                offset = int.from_bytes(comp[pos : pos + 4], "little")
                pos += 4
            read_index = len(out) - offset
            if offset == 0 or read_index < block_start:
                raise ValueError(
                    f"invalid backreference: offset {offset} at output {len(out)}"
                )
            # Forward byte-by-byte copy: offset < length replicates runs
            # (reference snappy_decompress.c:174-181).
            for _ in range(length):
                out.append(out[read_index])
                read_index += 1


def decompress(stream: bytes) -> bytes:
    """Decompress a framed stream produced by :func:`compress`."""
    view = memoryview(stream)
    total_len, pos = decode_varint32(view, 0)
    _block_size, pos = decode_varint32(view, pos)
    # The reference decoder reads the block size unchecked
    # (snappy_decompress.c:221); every engine here uniformly rejects
    # out-of-spec sizes (format max 64 KB, snappy/README.md:7) — a huge
    # declared size would otherwise drive the device paths' padded
    # allocations (fuzz tier: test_fuzz_malformed.py).
    if not 0 < _block_size <= C.MAX_BLOCK_SIZE:
        raise ValueError(
            f"declared block size {_block_size} outside (0, {C.MAX_BLOCK_SIZE}]"
        )
    out = bytearray()
    while pos < len(view):
        if len(out) >= total_len:
            raise ValueError("trailing frame after output is complete")
        if pos + C.BLOCK_FRAME_BYTES > len(view):
            raise ValueError("truncated block frame")
        comp_size = int.from_bytes(view[pos : pos + C.BLOCK_FRAME_BYTES], "little")
        pos += C.BLOCK_FRAME_BYTES
        if pos + comp_size > len(view):
            raise ValueError("block payload overruns stream")
        decompress_block(view[pos : pos + comp_size], out, len(out))
        pos += comp_size
    if len(out) != total_len:
        raise ValueError(f"decompressed {len(out)} bytes, header said {total_len}")
    return bytes(out)


def scan_block_frames(stream: bytes) -> tuple[int, int, list[tuple[int, int]]]:
    """Walk the stream's frames without decoding payloads.

    Returns ``(total_decompressed_length, block_size, frames)`` where each
    frame is ``(payload_offset, payload_size)``. This is the host pre-pass the
    reference performs before DPU decompression
    (``snappy_decompress.c:317-340``).
    """
    view = memoryview(stream)
    total_len, pos = decode_varint32(view, 0)
    block_size, pos = decode_varint32(view, pos)
    frames: list[tuple[int, int]] = []
    out_off = 0
    while pos < len(view):
        if out_off >= total_len:
            raise ValueError("trailing frame after output is complete")
        comp_size = int.from_bytes(view[pos : pos + C.BLOCK_FRAME_BYTES], "little")
        pos += C.BLOCK_FRAME_BYTES
        frames.append((pos, comp_size))
        pos += comp_size
        out_off += min(block_size, total_len - out_off)
    if pos != len(view):
        raise ValueError("trailing garbage after final block")
    return total_len, block_size, frames
