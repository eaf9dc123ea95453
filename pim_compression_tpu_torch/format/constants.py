"""Wire-format constants for the block-parallel modified-Snappy format.

The format (empirically verified against every ``.snappy`` file shipped in the
reference corpus; see reference ``snappy/README.md:19-33``):

    file   := varint32(decompressed_length)
              varint32(decompressed_block_size)
              block*
    block  := u32_le(compressed_size) compressed_data[compressed_size]

Inside a block, standard Snappy elements with a 2-bit type field in the tag
byte LSBs (reference ``snappy/dpu_snappy.h:28-34``).
"""

from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Element types (2-bit tag LSBs). Reference: snappy/dpu_snappy.h:28-34.
# ---------------------------------------------------------------------------


class ElementType(enum.IntEnum):
    LITERAL = 0
    COPY_1_BYTE_OFFSET = 1  # 4..11 byte length, 11-bit offset (< 2048)
    COPY_2_BYTE_OFFSET = 2  # 1..64 byte length, 16-bit offset
    COPY_4_BYTE_OFFSET = 3  # 1..64 byte length, 32-bit offset (decode-only)


def tag_element_type(tag: int) -> int:
    """2-bit element type in tag LSBs (reference snappy/dpu_snappy.h:10)."""
    return tag & 0b11


def tag_literal_length_minus1(tag: int) -> int:
    """Literal length field, bits 2-7 (reference snappy/dpu_snappy.h:11)."""
    return (tag >> 2) & 0x3F


def tag_copy1_length(tag: int) -> int:
    """COPY_1 length: bits 2-4 hold len-4 (reference snappy/dpu_snappy.h:12)."""
    return ((tag >> 2) & 0x7) + 4


def tag_copy1_offset_high(tag: int) -> int:
    """COPY_1 offset high 3 bits live in tag bits 5-7."""
    return (tag >> 5) & 0x7


def tag_copy_length_minus1(tag: int) -> int:
    """COPY_2 / COPY_4 length field, bits 2-7."""
    return (tag >> 2) & 0x3F


# Literal length field values >= 60 signal (field - 59) extra LE length bytes,
# whose value + 1 is the literal length.
LITERAL_MAX_INLINE_LEN = 60  # len-1 < 60 encoded inline in the tag

# Copy emission rules (reference snappy_compress.c:254-272):
#  while len >= 68: emit a 64-byte copy; if len > 64: emit a 60-byte copy;
#  remainder (always >= 4) emitted last.
COPY_CHUNK_THRESHOLD = 68
COPY_CHUNK_LEN = 64
COPY_PRE_REMAINDER_LEN = 60
MIN_MATCH_LEN = 4
MAX_COPY_LEN = 64
COPY1_MAX_LEN = 11
COPY1_MAX_OFFSET = 1 << 11  # 2048
COPY2_MAX_OFFSET = 1 << 16

# Compressor heuristics (reference snappy_compress.c).
INPUT_MARGIN_BYTES = 15  # last 15 bytes always emitted as a trailing literal
HASH_MULTIPLIER = 0x1E35A7BD  # multiplicative hash constant (:161-166)
MAX_HASH_TABLE_BITS = 14  # table grows 256 -> 2^14 entries (:139-146)
MIN_HASH_TABLE_ENTRIES = 256
SKIP_INITIAL = 32  # probe-skip heuristic seed (:333-348)

# Framing.
BLOCK_FRAME_BYTES = 4  # u32 LE compressed-size prefix per block
DEFAULT_BLOCK_SIZE = 32 * 1024  # reference default (snappy/dpu_snappy.c:100)
MAX_BLOCK_SIZE = 64 * 1024  # offsets must fit COPY_2 (snappy/README.md:7)

# Capacity model (reference snappy_compress.c:55-60).


def max_compressed_length(n: int) -> int:
    """Worst-case compressed size of ``n`` input bytes: 32 + n + n/6."""
    return 32 + n + n // 6


# Reference input cap: NR_DPUS * 30 MB MRAM (snappy/dpu_snappy.h:18). The TPU
# framework has no such per-device cap; we keep a sanity bound for the host
# oracle paths only.
MAX_FILE_LENGTH_REFERENCE = 30 * 1024 * 1024
