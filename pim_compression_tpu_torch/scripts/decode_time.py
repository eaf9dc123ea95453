"""Time the decode kernel on the main paths' batches and on fixed streams.

    python3 -m pim_compression_tpu_torch.scripts.decode_time [--device cuda:0]

Runs ``csrc/decode.cu`` through ``ops.hopper_decode.decode_blocks`` on
device-resident batches: the first 1024 blocks of the native codec's
streams of ``chip_smoke.py``'s seeded payloads at bs 32768 and 65536 (its
phases 4 and 10), the 188-block batch of its phase 3 at 65536 (128 payload
blocks, the hand-built blocks, the far-repeat block and 48 mutants), and
1024 copies of each fixed 32 KB block of ``fixed_blocks``, which split a walk's
cost by element: copies only at offsets up to 16 KB, copies only at offsets
above 16 KB (read from the row, not the history ring), one-byte literals
alternating with copies, one literal as long as the block, and run-length
copies at offset 1; then the near copies at ``RESIDENCY`` batch sizes (one
walk alone, one to twelve walks an SM), which tell a walk's own chain from
the SM's shared issue. Each time is the mean device time of 20 back-to-back
launches by CUDA events. Each record carries a digest of the output rows and
error words, which two versions of the kernel must share (every byte of
every row, malformed blocks included), the elements per block (mean and
max, counted here on the host), the share of copies that read at least one
byte from more than 16 KB back, and the cycles per element of the block
with the most elements, at the 1.98 GHz boost clock. Writes
``build/probes/decode_time.json`` and prints one JSON line.

It runs as a file too, with another checkout's package first on
``PYTHONPATH`` (``PYTHONPATH=old python3 path/to/decode_time.py``), so that
two versions of the kernel are timed in one run on one card.
"""

from __future__ import annotations

import hashlib
import json
import random

import numpy as np
import torch

from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.ops import hopper_decode
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import common
from pim_compression_tpu_torch.utils import streams

SEED = 20261016
BLOCKS = 1100  # the payloads' length in blocks, less 1000 bytes (chip_smoke.py)
BATCH = 1024
REPS = 20
BOOST_HZ = 1.98e9
FAR = 16384  # bytes of history the redesigned kernel keeps in shared memory
FIXED_BS = 32768
RESIDENCY = (1, 132, 528, 1056, 1584)  # batch sizes of the residency sweep (132 SMs)


def _copy(offset: int, length: int) -> bytes:
    return streams._copy(offset, length, 2)


def _grow(payload: bytes, o: int, to: int) -> tuple[bytes, int]:
    """64-byte copies at offset 64 that take the output from o to about ``to``."""
    while o + 64 <= to:
        payload += _copy(64, 64)
        o += 64
    return payload, o


def fixed_blocks(bs: int = FIXED_BS) -> dict[str, tuple[bytes, int]]:
    """name -> (payload, out_len) of each fixed block."""
    rng = random.Random(SEED)
    head = rng.randbytes(64)
    out = {}
    payload, o = streams._literal(head), 64  # copies of 12 bytes (the text's mean is 11.5) reaching back up to 16 KB
    while o + 12 <= bs:
        payload += _copy(min(o, FAR - 12), 12)
        o += 12
    out["copies, offsets <= 16 KB"] = payload, o
    payload, o = _grow(streams._literal(head), 64, 20032)  # then copies from 20000 back
    while o + 12 <= bs:
        payload += _copy(20000, 12)
        o += 12
    out["copies, offsets > 16 KB"] = payload, o
    payload, o = streams._literal(rng.randbytes(100)), 100
    while o + 13 <= bs:
        payload += streams._literal(rng.randbytes(1)) + _copy(100, 12)
        o += 13
    out["1-byte literals and copies"] = payload, o
    out["one literal"] = streams._literal(rng.randbytes(bs)), bs
    payload, o = streams._literal(head[:1]), 1
    while o + 64 <= bs:
        payload += _copy(1, 64)
        o += 64
    out["runs at offset 1"] = payload, o
    return out


def parse_counts(payload: bytes) -> tuple[int, int, int]:
    """(elements, copies, copies reading a byte from more than FAR back) of a
    valid payload; a copy at offset d of length n reads from there when
    d > FAR - n."""
    p = elements = copies = far = 0
    n = len(payload)
    while p < n:
        tag = payload[p]
        kind = tag & 3
        elements += 1
        if kind == 0:
            lf = tag >> 2
            ext = lf - 59 if lf >= 60 else 0
            length = (int.from_bytes(payload[p + 1 : p + 1 + ext], "little") if ext else lf) + 1
            p += 1 + ext + length
            continue
        if kind == 1:
            length, off = ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | payload[p + 1]
            p += 2
        else:
            width = 2 if kind == 2 else 4
            length, off = (tag >> 2) + 1, int.from_bytes(payload[p + 1 : p + 1 + width], "little")
            p += 1 + width
        copies += 1
        far += off > FAR - length
    return elements, copies, far


def _blocks(stream: bytes) -> list[tuple[bytes, int]]:
    info = pipeline.scan_frames(stream)
    return [(stream[o : o + s], int(m)) for o, s, m in zip(info["payload_off"], info["payload_size"], info["out_size"])]


def cases() -> list[tuple[str, int, list, list | None]]:
    """(name, bs, blocks, the number of valid blocks first or None for
    all) of each timed batch, on the host."""
    out = []
    for bs in (32768, 65536):
        payload = streams.text_payload(BLOCKS * bs - 1000, SEED)
        blocks = _blocks(native.compress(payload, bs))
        out.append((f"{bs} text, {BATCH} blocks", bs, blocks[:BATCH], None))
        if bs == 65536:  # chip_smoke.py phase 3's wide batch
            far = streams.far_repeat_block(bs, SEED)
            hand = streams.hand_blocks(bs) + _blocks(native.compress(far, bs))
            wide = blocks[:128] + hand
            wide += streams.block_mutants(wide, random.Random(SEED + 2), 48, bs)
            out.append((f"{bs} phase-3 batch, {len(wide)} blocks", bs, wide, len(wide) - 48))
    out += fixed_cases()
    # The near copies at other batch sizes: one walk alone on the card, one
    # or two an SM scheduler, and every slot the kernel has.
    near = fixed_blocks()["copies, offsets <= 16 KB"]
    for nb in RESIDENCY:
        out.append((f"{FIXED_BS} fixed: copies, offsets <= 16 KB, {nb} blocks", FIXED_BS, [near] * nb, None))
    return out


def fixed_cases() -> list[tuple[str, int, list, None]]:
    """The cases of ``cases`` that split a walk's cost by element: a batch of
    ``BATCH`` copies of each of ``fixed_blocks``."""
    return [(f"{FIXED_BS} fixed: {name}", FIXED_BS, [block] * BATCH, None) for name, block in fixed_blocks().items()]


def counts(blocks, valid: int | None) -> dict:
    """Elements per block (mean, max) and the far-copy share, over the valid blocks."""
    seen, per_block, copies, far = {}, [], 0, 0
    for payload, _ in blocks[:valid]:
        if payload not in seen:
            seen[payload] = parse_counts(payload)
        e, c, f = seen[payload]
        per_block.append(e)
        copies += c
        far += f
    return {"elements_mean": float(np.mean(per_block)), "elements_max": int(max(per_block)),
            "far_copy_share": far / max(1, copies)}


def slots(blocks, bs: int, dev) -> tuple[torch.Tensor, ...]:
    cap = pipeline.padded_capacity(bs)
    comp = np.zeros((len(blocks), cap), np.uint8)
    clen = np.zeros(len(blocks), np.int32)
    olen = np.zeros(len(blocks), np.int32)
    for i, (payload, n) in enumerate(blocks):
        comp[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        clen[i], olen[i] = len(payload), n
    return tuple(torch.from_numpy(a).to(dev) for a in (comp, clen, olen))


def inputs(dev, todo) -> list[tuple]:
    """(name, bs, (comp, comp_len, out_len) on the card, counts) of each case."""
    return [(name, bs, slots(blocks, bs, dev), counts(blocks, valid)) for name, bs, blocks, valid in todo]


def time_cases(todo) -> list[dict]:
    """Mean device ms of REPS launches of decode_blocks on each case, with
    the output's digest and the cycles per element of its largest block."""
    records = []
    for name, bs, args, stats in todo:
        out, err = hopper_decode.decode_blocks(*args, block_size=bs)
        digest = hashlib.sha256(out.cpu().numpy().tobytes() + err.cpu().numpy().tobytes()).hexdigest()[:16]
        # The timed launches' outputs are dropped, so the allocator hands each
        # the memory of the one before, with no allocation inside the timing.
        ms = common.event_seconds(lambda: hopper_decode.decode_blocks(*args, block_size=bs), REPS) * 1e3
        records.append({"case": name, "bs": bs, "blocks": int(args[0].shape[0]), "ms": ms, "digest": digest,
                        "errors": int((err != 0).sum()), **stats,
                        "cycles_per_element": ms * 1e-3 * BOOST_HZ / stats["elements_max"]})
    return records


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    todo = inputs(dev, cases())
    common.warm(dev)
    head = {"card": common.card(dev), "kernel_source": hopper_decode.__file__}
    if hasattr(hopper_decode, "walks_per_sm"):
        head["walks_per_sm"] = hopper_decode.walks_per_sm(dev)
    return [head] + time_cases(todo)


def main(argv=None) -> int:
    rc = common.main("decode_time", run, __doc__.splitlines()[0], argv)
    print(json.dumps(json.loads((common.OUT_DIR / "decode_time.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
