"""The port's bounded-depth batch pipeline (``pipeline_depth``), against the JAX package.

``runtime.compress`` and ``runtime.decompress`` keep up to
``pipeline_depth`` batches in flight through the device's staging ring
(``runtime.staging``), as the JAX runtime keeps them in flight through
XLA's asynchronous dispatch. On the ``torch`` engine on the CPU the same
schedule runs without streams, so these tests hold it here: the stream at
every depth and batch size equals the JAX ``pallas`` engine's (interpret
mode), the schedule keeps at most ``depth`` batches in flight and drains
them in launch order, errors name the blocks the JAX runtime names, and the
synchronous mode keeps its per-phase syncs. The ring on the card (pinned
buffers, streams, overlap) is tested in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest
import torch

from pim_compression_tpu import runtime as ref_runtime
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu.utils.errors import SnappyError as RefSnappyError
from pim_compression_tpu_torch import TorchCodecConfig, runtime
from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode
from pim_compression_tpu_torch.runtime import pipeline, staging
from pim_compression_tpu_torch.utils import streams
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

BS = 1024


def _payload(num_blocks: int, block_size: int, random_at: tuple[int, ...], seed: int) -> bytes:
    """Text blocks with seeded random blocks spliced in, the last block partial."""
    r = random.Random(seed)
    text = streams.text_payload(num_blocks * block_size - block_size // 3, seed)
    for i in random_at:
        text = text[: i * block_size] + r.randbytes(block_size) + text[(i + 1) * block_size :]
    return text


@pytest.fixture(scope="module")
def reference():
    """15 blocks at bs 1024 with 2 random blocks, and the JAX pallas engine's
    stream of them at depth 3 (interpret mode) with its timer's notes."""
    data = _payload(15, BS, (4, 9), 31)
    timer = ref_runtime.PhaseTimer()
    stream = ref_runtime.compress(data, CodecConfig(engine="pallas", block_size=BS, pipeline_depth=3), timer)
    return data, bytes(stream), dict(timer.notes)


def _cfg(**kw) -> TorchCodecConfig:
    return TorchCodecConfig(engine="torch", **kw)


# ---------------------------------------------------------------------------
# (a) Streams at every depth and batch size.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_blocks", [1, 3, 4])
@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_stream_equals_jax_at_every_depth(reference, depth, batch_blocks):
    data, want, notes = reference
    timer = runtime.PhaseTimer()
    got = runtime.compress(data, _cfg(block_size=BS, batch_blocks=batch_blocks, pipeline_depth=depth), timer)
    assert bytes(got) == want
    assert timer.notes == notes and notes["raw_blocks"] == 2


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_decompress_gives_the_data_back_at_every_depth(reference, depth):
    data, stream, _ = reference
    assert bytes(runtime.decompress(stream, _cfg(batch_blocks=5, pipeline_depth=depth))) == data


# ---------------------------------------------------------------------------
# (b) The schedule.
# ---------------------------------------------------------------------------


def _record(monkeypatch, entry_module, entry_name):
    """Record ("launch", n) at the engine's entry point and ("drain", batch)
    at each slot's wait for its d2h copies."""
    events = []
    entry = getattr(entry_module, entry_name)

    def launch(*args, **kw):
        events.append(("launch", len(args[0])))
        return entry(*args, **kw)

    ready = staging.Slot.ready

    def drain(slot):
        batch = ready(slot)
        events.append(("drain", batch))
        return batch

    monkeypatch.setattr(entry_module, entry_name, launch)
    monkeypatch.setattr(staging.Slot, "ready", drain)
    return events


def _check_schedule(events, depth: int, count: int) -> None:
    launched = drained = 0
    for kind, what in events:
        if kind == "launch":
            launched += 1
        else:
            assert what == drained, f"batch {what} drained as the {drained}th: not in launch order"
            drained += 1
        assert launched - drained <= max(1, depth), "more than depth batches in flight"
    assert (launched, drained) == (count, count), "each batch launched and drained once"
    kinds = [k for k, _ in events]
    if depth <= 1:
        assert kinds == ["launch", "drain"] * count
    else:  # the oldest is drained only once depth batches (or all) are in flight
        first = min(depth, count)
        assert kinds[: first + 1] == ["launch"] * first + ["drain"]


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 5])
def test_decompress_schedule(monkeypatch, depth):
    data = streams.text_payload(7 * 256 - 50, 7)
    stream = bytes(runtime.compress(data, _cfg(block_size=256)))
    events = _record(monkeypatch, hopper_decode, "decode_blocks_torch")
    assert bytes(runtime.decompress(stream, _cfg(batch_blocks=1, pipeline_depth=depth))) == data
    assert [n for k, n in events if k == "launch"] == [1] * 7
    _check_schedule(events, depth, 7)


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 5])
def test_compress_schedule(monkeypatch, depth):
    data = streams.text_payload(7 * 256 - 50, 7)
    want = bytes(runtime.compress(data, _cfg(block_size=256)))
    events = _record(monkeypatch, hopper_encode, "encode_blocks_torch")
    got = runtime.compress(data, _cfg(block_size=256, batch_blocks=2, pipeline_depth=depth))
    assert bytes(got) == want
    assert [n for k, n in events if k == "launch"] == [2, 2, 2, 1]
    _check_schedule(events, depth, 4)


# ---------------------------------------------------------------------------
# (c)-(e) Errors at drain time, and the call after one.
# ---------------------------------------------------------------------------


def _corrupt(stream: bytes, blocks: tuple[int, ...]) -> bytes:
    info = pipeline.scan_frames(stream)
    bad = bytearray(stream)
    for b in blocks:
        bad[int(info["payload_off"][b])] = 0x01  # the block opens with a copy: nothing to copy from
    return bytes(bad)


def test_validate_names_the_jax_block(reference):
    # Corrupt blocks in the 3rd and 4th of 5 batches (3 blocks each): the JAX
    # runtime at depth 3 and the port at depths 3 and 1 all name the 3rd's.
    _, stream, _ = reference
    bad = _corrupt(stream, (7, 10))
    with pytest.raises(RefSnappyError) as ref:
        ref_runtime.decompress(bad, CodecConfig(engine="pallas", pipeline_depth=3))
    assert "block 7 " in str(ref.value)
    for depth in (3, 1):
        with pytest.raises(SnappyError) as e:
            runtime.decompress(bad, _cfg(batch_blocks=3, pipeline_depth=depth))
        assert e.value.status == SnappyStatus.INVALID_INPUT
        assert str(e.value).split(" failed")[0] == str(ref.value).split(" failed")[0] == "block 7"


def _bad_encoder(monkeypatch, bad_call: int):
    """The encoder corrupts block 1 of its ``bad_call``-th batch (from 1)."""
    encode = hopper_encode.encode_blocks_torch
    calls = []

    def corrupt(blocks, lens, **kw):
        comp, sizes = encode(blocks, lens, **kw)
        calls.append(len(blocks))
        if len(calls) == bad_call:
            comp[1, 0] ^= 0x04  # block 1's first tag now claims one more byte
        return comp, sizes

    monkeypatch.setattr(hopper_encode, "encode_blocks_torch", corrupt)
    return calls


def test_verify_names_the_same_blocks_at_depth_3_and_1(reference, monkeypatch):
    data, _, _ = reference
    named = {}
    for depth in (3, 1):
        calls = _bad_encoder(monkeypatch, 2)
        with pytest.raises(SnappyError) as e:
            runtime.compress(data, _cfg(block_size=BS, batch_blocks=3, pipeline_depth=depth, verify=True))
        assert e.value.status == SnappyStatus.INVALID_INPUT
        named[depth] = str(e.value)
        # Raised at batch 1's drain: at depth 3 batches 0-3 were launched by then.
        assert len(calls) == (4 if depth == 3 else 2)
    # Batch 1 holds device blocks 3-5, which are blocks 3, 5 and 6 (block 4 is raw).
    assert named[3] == named[1] == "on-device verify failed for blocks [5]"


@pytest.mark.parametrize("direction", ["decompress", "compress"])
def test_a_call_after_an_error_gives_correct_bytes(reference, monkeypatch, direction):
    data, stream, _ = reference
    cfg = _cfg(block_size=BS, batch_blocks=8, pipeline_depth=3)  # two batches, both in flight
    if direction == "decompress":
        with pytest.raises(SnappyError):
            runtime.decompress(_corrupt(stream, (4,)), cfg)
        assert bytes(runtime.decompress(stream, cfg)) == data
    else:
        with monkeypatch.context() as m:
            _bad_encoder(m, 2)
            with pytest.raises(SnappyError):
                runtime.compress(data, dataclasses.replace(cfg, verify=True))
        assert bytes(runtime.compress(data, cfg)) == stream
    for ring in staging._POOL["cpu"]:
        assert all(slot.batch is None for slot in ring.slots), "a slot still holds a batch after the call"


# ---------------------------------------------------------------------------
# (f) The synchronous mode keeps its per-phase syncs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "depth, batch_blocks, syncs_per_batch",
    [(0, 2, 2), (1, 2, 2), (2, 100, 2), (2, 2, 0), (4, 2, 0)],
    ids=["depth-0", "depth-1", "one-batch", "depth-2", "depth-4"],
)
@pytest.mark.parametrize("direction", ["decompress", "compress"])
def test_synchronous_mode_keeps_the_per_phase_sync(monkeypatch, direction, depth, batch_blocks, syncs_per_batch):
    data = streams.text_payload(6 * 256 - 10, 12)
    stream = bytes(runtime.compress(data, _cfg(block_size=256)))
    syncs = []
    monkeypatch.setattr(staging.Slot, "synchronize", lambda slot: syncs.append(slot.batch))
    timer = runtime.PhaseTimer()
    cfg = _cfg(block_size=256, batch_blocks=batch_blocks, pipeline_depth=depth)
    if direction == "decompress":
        assert bytes(runtime.decompress(stream, cfg, timer)) == data
    else:
        assert bytes(runtime.compress(data, cfg, timer)) == stream
    count = -(-6 // batch_blocks)
    # After the h2d copy and after the kernels of every batch, in order.
    assert syncs == [b for b in range(count) for _ in range(syncs_per_batch)]
    assert all(timer.seconds[p] > 0 for p in ("h2d", "kernel", "d2h"))


# ---------------------------------------------------------------------------
# The staging ring.
# ---------------------------------------------------------------------------


def test_ring_is_pooled_and_grown_only_when_needed(monkeypatch):
    monkeypatch.setattr(staging, "_POOL", {})  # no ring of another test
    dev = torch.device("cpu")
    spec = {"in": {"a": ((4, 100), torch.uint8), "n": ((4,), torch.int32)}, "out": {"b": ((4, 7), torch.int32)}}
    with staging.acquire(dev, 2, spec) as ring:
        arenas = [dict(s.arenas) for s in ring.slots]
        views = ring.slots[1].views
        assert views["a"].shape == (4, 100) and views["n"].dtype == torch.int32 and views["b"].shape == (4, 7)
        assert views["n"].data_ptr() - views["a"].data_ptr() == 512  # 400 bytes, 256-aligned
    smaller = {"in": {"a": ((2, 100), torch.uint8)}, "out": {"b": ((1, 7), torch.int32)}}
    with staging.acquire(dev, 1, smaller) as again:
        assert again is ring and again.active == 1
        assert again.slots[0].arenas["in"] is arenas[0]["in"], "a large enough arena is reused"
    larger = {"in": {"a": ((8, 100), torch.uint8)}, "out": {"b": ((4, 7), torch.int32)}}
    with staging.acquire(dev, 3, larger) as grown:
        assert grown is ring and len(grown.slots) == 3 and grown.active == 3
        assert grown.slots[0].arenas["in"].numel() == 1024 and grown.slots[0].arenas["out"] is arenas[0]["out"]


def test_run_drains_in_launch_order_within_depth():
    ring = staging.Ring(torch.device("cpu"))
    ring.fit(3, {})
    events = []
    staging.run(
        ring, 7, 3,
        lambda i, slot: events.append(("stage", i, ring.slots.index(slot))) or -i,
        lambda i, slot, staged: events.append(("launch", staged, ring.slots.index(slot))) or i,
        lambda i, slot, held: events.append(("drain", held, ring.slots.index(slot))),
    )
    for kind, sign in (("stage", 1), ("launch", -1), ("drain", 1)):
        assert [e for e in events if e[0] == kind] == [(kind, sign * i, i % 3) for i in range(7)]
    # The ring fills with staged batches first; then a slot is staged again
    # only once the batch before it there is drained, just before its launch.
    assert [e[:2] for e in events] == [
        ("stage", 0), ("stage", 1), ("stage", 2), ("launch", 0), ("launch", -1), ("launch", -2), ("drain", 0),
        ("stage", 3), ("launch", -3), ("drain", 1), ("stage", 4), ("launch", -4), ("drain", 2),
        ("stage", 5), ("launch", -5), ("drain", 3), ("stage", 6), ("launch", -6), ("drain", 4),
        ("drain", 5), ("drain", 6),
    ]


def test_failed_pinned_allocation_raises(monkeypatch):
    # Only the device's type is read before the allocation, so the CPU can
    # stand in for a card: a failed or unpinned allocation raises.
    cuda = torch.device("cuda", 0)

    def fail(nbytes):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(staging, "_pinned_empty", fail)
    with pytest.raises(SnappyError) as e:
        staging._host_buffer(cuda, 1 << 20)
    assert e.value.status == SnappyStatus.BUFFER_TOO_SMALL and "pinned" in str(e.value)
    monkeypatch.setattr(staging, "_pinned_empty", lambda nbytes: torch.empty(nbytes, dtype=torch.uint8))
    with pytest.raises(SnappyError, match="not pinned"):
        staging._host_buffer(cuda, 1 << 20)


def test_all_raw_input_acquires_no_ring(monkeypatch):
    data = np.random.default_rng(3).integers(0, 256, 4 * BS, dtype=np.uint8).tobytes()
    timer = runtime.PhaseTimer()
    with monkeypatch.context() as m:
        m.setattr(staging, "acquire", lambda *a: pytest.fail("a ring for no batch"))
        stream = runtime.compress(data, _cfg(block_size=BS), timer)
    assert timer.notes["raw_blocks"] == 4
    assert bytes(runtime.decompress(bytes(stream), _cfg())) == data
