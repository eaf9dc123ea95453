"""The frozen generator, the working set made from the seed, and the plain
Snappy block codec the comparison relies on."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from hopper_bench.yardstick import snappy_ref as R
from hopper_bench.yardstick import textgen, working_set

# The frozen generator's output, pinned when it was copied: a change to the
# copy changes every cell's data.
TEXT_DIGEST = "c1abbfbb6844e0b9a643b3377c86e5b593a94a74246a4f78e6f348ebe62aab5c"
LAYOUT = working_set.Layout(block_size=1024, batch_blocks=4, resident_bytes=32 << 10, base_bytes=8 << 10)


def test_the_frozen_generator_is_unchanged():
    text = textgen.text_payload(1 << 16, 20261016)
    assert len(text) == 1 << 16
    assert hashlib.sha256(text).hexdigest() == TEXT_DIGEST


def test_equal_seeds_give_equal_bytes():
    base = working_set.base_text(LAYOUT, 7)
    for seed in (3, 2**31 + 9, -4):
        a = [working_set.batch_plain(LAYOUT, base, working_set.permutations(LAYOUT, seed), b) for b in range(LAYOUT.batches)]
        b = [working_set.batch_plain(LAYOUT, base, working_set.permutations(LAYOUT, seed), b) for b in range(LAYOUT.batches)]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert working_set.batch_order(LAYOUT, seed) == working_set.batch_order(LAYOUT, seed)
    assert not np.array_equal(working_set.permutations(LAYOUT, 3), working_set.permutations(LAYOUT, 4))


def test_copies_differ_and_keep_every_repeat():
    base = working_set.base_text(LAYOUT, 7)
    perms = working_set.permutations(LAYOUT, 11)
    assert all(sorted(p.tolist()) == list(range(256)) for p in perms)
    assert len({bytes(p) for p in perms}) == LAYOUT.copies
    assert sorted(working_set.batch_order(LAYOUT, 11)) == list(range(LAYOUT.batches))
    batches = [working_set.batch_plain(LAYOUT, base, perms, b).ravel() for b in range(LAYOUT.batches)]
    # a batch of 4 KiB holds a quarter of an 8 KiB copy; 4 copies in all
    assert np.array_equal(np.concatenate(batches[:2]), perms[0][base])
    assert len({bytes(b) for b in batches}) == LAYOUT.batches
    first = np.concatenate(batches[:2])
    for j in range(1, LAYOUT.copies):
        copy = np.concatenate(batches[2 * j : 2 * j + 2])
        # the same bytes are equal at the same places: every repeat is kept
        back = np.argsort(perms[j])[copy]
        assert np.array_equal(perms[0][back], first)


def test_more_copies_than_byte_values():
    layout = working_set.Layout(block_size=256, batch_blocks=2, resident_bytes=600 * 512, base_bytes=1024)
    perms = working_set.permutations(layout, 2**31 + 5)
    assert perms.shape == (300, 256) and len({bytes(p) for p in perms}) == 300
    base = working_set.base_text(layout, 7)
    # a batch of 512 bytes is half a copy: batch 301 is copy 150's second half
    assert np.array_equal(working_set.batch_plain(layout, base, perms, 301).ravel(), perms[150][base[512:]])


def test_every_batch_costs_the_same_work():
    # An encoder keyed by the exact 4-byte word sees the same repeats in every
    # copy, so every batch of a copy's part compresses to the same sizes.
    layout = working_set.Layout(block_size=4096, batch_blocks=2, resident_bytes=64 << 10, base_bytes=16 << 10)
    base = working_set.base_text(layout, 20261016)
    perms = working_set.permutations(layout, 5)
    sizes = [[len(R.encode_block(row.tobytes())) for row in working_set.batch_plain(layout, base, perms, b)]
             for b in range(layout.batches)]
    per_copy = layout.base_bytes // layout.batch_bytes
    for b in range(per_copy, layout.batches):
        assert sizes[b] == sizes[b % per_copy]


def test_layout_refuses_ragged_sets():
    with pytest.raises(ValueError):
        working_set.Layout(block_size=1024, batch_blocks=3, resident_bytes=32 << 10, base_bytes=8 << 10)
    with pytest.raises(ValueError):
        working_set.Layout(block_size=1024, batch_blocks=4, resident_bytes=12 << 10, base_bytes=8 << 10)


def _lit(data: bytes) -> bytes:
    out = bytearray()
    R._literal(out, data, 0, len(data))
    return bytes(out)


def test_plain_decoder_on_hand_built_blocks():
    # literal "abcd", copy1 len 4 off 4, copy2 len 6 off 2 (a run), literal "xy"
    block = bytes([3 << 2]) + b"abcd" + bytes([1 | (0 << 2), 4]) + bytes([2 | (5 << 2), 2, 0]) + bytes([1 << 2]) + b"xy"
    assert R.decode_block(block, 16) == b"abcdabcdcdcdcdxy"
    # a 4-byte-offset copy and a literal with one and two extra length bytes
    lit100, lit300 = bytes(range(100)), bytes(range(256)) + bytes(44)
    assert R.decode_block(_lit(lit100), 100) == lit100 and _lit(lit100)[0] == 60 << 2
    assert R.decode_block(_lit(lit300), 300) == lit300 and _lit(lit300)[0] == 61 << 2
    assert R.decode_block(b"\x0cabcd" + bytes([3 | (7 << 2), 4, 0, 0, 0]), 12) == b"abcdabcdabcd"
    # the snapshot control breaks the run and only the run
    assert R.decode_block(block, 16, overlap=False) == b"abcdabcdcd\0\0\0\0xy"


@pytest.mark.parametrize("bad,length", [
    (bytes([1, 0]), 4),  # a copy at position 0
    (b"\x0cabcd" + bytes([1 | (0 << 2), 0]), 8),  # offset 0
    (b"\x0cabcd" + bytes([2 | (3 << 2), 9, 0]), 8),  # offset past the start
    (b"\x0cabc", 4),  # literal past the end
    (b"\x0cabcd", 5),  # fewer bytes than the block's length
    (b"\x0cabcd" + bytes([2 | (3 << 2), 4]), 8),  # offset cut off
])
def test_plain_decoder_refuses_bad_blocks(bad, length):
    with pytest.raises(R.BlockError):
        R.decode_block(bad, length)


def test_plain_encoder_round_trips_and_its_control_breaks():
    text = textgen.text_payload(3 * 32768, 3)
    blocks = [text[i : i + 32768] for i in range(0, len(text), 32768)] + [b"a" * 5000, bytes(20), b"xyz"]
    for b in blocks:
        assert R.decode_block(R.encode_block(b), len(b)) == b
        assert R.decode_block(R.encode_block(b, key_bits=12), len(b)) == b
    broken = 0
    for b in blocks[:3]:
        try:
            broken += R.decode_block(R.encode_block(b, key_bits=16, verify=False), len(b)) != b
        except R.BlockError:
            broken += 1
    assert broken == 3
    digests = [R.digest(b) for b in blocks]
    comps = [R.encode_block(b) for b in blocks]
    assert R.check_blocks((comps, [len(b) for b in blocks], digests)) == []
    comps[1] = comps[1][:-1]
    assert R.check_blocks((comps, [len(b) for b in blocks], digests)) == [1]


def test_framed_bytes():
    # header varints of 2**25 (4 bytes) and 32768 (3 bytes), then 4 bytes a block
    assert R.framed_bytes(1 << 25, 32768, 1000, 1024) == 4 + 3 + 4 * 1024 + 1000
    assert R.varint_len(127) == 1 and R.varint_len(128) == 2 and R.varint_len(0) == 1
