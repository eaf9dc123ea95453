"""Public codec API of the port: ``compress`` / ``decompress`` with engine dispatch.

Engines:
- ``oracle``: the pure-Python arbiter (the port's copy of the reference's).
- ``native``: the C++ threaded host codec (the port's copy, passes through).
- ``cuda``: the hand-written Hopper kernels (match or sweep, emit, decode)
  on one CUDA device.
- ``torch``: their plain PyTorch versions, on the CPU or a GPU.
- ``portable``: the reference's ``xla`` engine (``ops/decode.py``,
  ``ops/encode.py``: plain PyTorch tensor ops, no hand-written kernel), on
  a GPU or, when asked, the CPU.

Ported from ``pim_compression_tpu.runtime.api``. The ``cuda`` and ``torch``
engines emit the same streams as the reference's ``pallas`` engine at the
same config, the ``portable`` engine the same as its ``xla`` engine. Where
the reference's ``pallas`` engine falls back to ``xla`` on compress (outside
the kernels' envelope, ``_envelope_fallback``), the ``cuda`` and ``torch``
engines fall back to ``portable`` on the same device, loudly, or raise
under ``strict_engine``.
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus
from pim_compression_tpu_torch.ops import _build, hopper_decode, hopper_encode
from pim_compression_tpu_torch.ops import decode as decode_ops, encode as encode_ops
from pim_compression_tpu_torch.parallel import resolve_device
from pim_compression_tpu_torch.runtime import pipeline, staging
from pim_compression_tpu_torch.runtime.profiling import PhaseTimer
from pim_compression_tpu_torch.utils.config import TorchCodecConfig


def _schedule(config: TorchCodecConfig, count: int) -> tuple[int, bool, int]:
    """(depth, synchronous, slots) of ``count`` batches, as the JAX runtime
    decides them: ``depth = max(1, pipeline_depth)``, synchronous at depth 1
    or for a single batch, one slot per batch in flight."""
    depth = max(1, config.pipeline_depth)
    sync = depth <= 1 or count <= 1
    return (1, True, 1) if sync else (depth, False, min(depth, count))


def _envelope_fallback(config: TorchCodecConfig) -> tuple[str, str] | None:
    """The encode envelope's gap for the ``cuda`` and ``torch`` engines, or
    None: the reference's ``_pallas_or_fallback`` (``runtime/api.py:38-98``)
    for compress. On a gap it raises ``SnappyError(BAD_ARGUMENT)`` under
    ``strict_engine`` (before any device work), and otherwise returns the
    gap and the warning's message, and the caller compresses on the
    ``portable`` engine instead. Keyed on the envelope alone: a kernel that
    fails to build or launch raises and never falls back."""
    if config.engine not in ("cuda", "torch"):
        return None
    gap = hopper_encode.envelope_gap(config)
    if gap is None:
        return None
    msg = (
        f"{config.engine} engine: {gap} (block_size {config.block_size}) — falling back "
        "to the portable engine"
    )
    if config.strict_engine:
        raise SnappyError(SnappyStatus.BAD_ARGUMENT, msg)
    return gap, msg


def _decode_portable(comp, comp_len, out_len, *, block_size: int):
    """``decode_ops.decode_blocks`` on the slots with every byte at or past
    a block's ``comp_len`` zeroed first: the staging slots hold stale bytes
    there, which the portable decode's speculative tags can read for a
    malformed block, so its error bits and (with ``validate=False``) its
    bytes would follow the slot's history. Zeroed, they are those of the
    reference's decode on freshly zeroed slots."""
    col = torch.arange(comp.shape[1], dtype=torch.int32, device=comp.device)
    comp = torch.where(col < comp_len[:, None], comp, 0)
    return decode_ops.decode_blocks(comp, comp_len, out_len, block_size=block_size)


def _runs(idx: np.ndarray) -> list[tuple[int, int, int]]:
    """The contiguous runs of the sorted block indices ``idx``, each as
    (its position in ``idx``, its first block, its length): a batch's rows
    are copied run by run, each one contiguous copy."""
    starts = np.concatenate([[0], np.flatnonzero(np.diff(idx) != 1) + 1])
    lengths = np.diff(np.append(starts, idx.size))
    return list(zip(starts.tolist(), idx[starts].tolist(), lengths.tolist()))


def decompress(
    stream: bytes,
    config: TorchCodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> bytes | bytearray:
    """Decompress a framed stream.

    The device engines decode batches of ``config.batch_blocks`` blocks
    (plus a tail batch), each h2d -> decode -> d2h through a slot of the
    device's staging ring (``runtime.staging``: pinned host buffers and a
    CUDA stream per slot), straight into one output buffer at ``start *
    block_size``; they return it without a detaching copy when it is 1 MiB
    or more. As in the JAX runtime, up to ``config.pipeline_depth`` batches
    are in flight: batch i+1's h2d and kernel run while batch i comes back,
    and batches are drained in launch order; a batch's input is copied into
    its slot as soon as the slot is free, so the ring fills before the
    first launch. Synchronous mode (depth <= 1,
    or a single batch) closes every phase with a sync, so each phase is the
    time of its own work. In pipelined mode ``h2d`` is the host copy into
    the slot plus the time to enqueue the copy, ``kernel`` the time to
    enqueue the kernel and the d2h copy, and ``d2h`` the wait for the batch
    plus the host copy out of the slot. With ``config.validate``, a block
    with any error bit raises ``SnappyError`` when its batch is drained,
    naming the first such block in drain order. One-time device set-up (the
    kernels' build, the CUDA context, the ring's streams and first pinned
    allocation) is timed under ``compile``. A stream of no blocks gives
    ``b""`` on every engine, with or without a device.
    """
    config = config or TorchCodecConfig()
    timer = timer if timer is not None else PhaseTimer()

    if config.engine == "oracle":
        with timer.phase("kernel"):
            return oracle.decompress(stream)
    if config.engine == "native":
        with timer.phase("kernel"):
            return native.decompress(stream, num_threads=config.num_threads)

    with timer.phase("pre"):
        info = pipeline.scan_frames(stream)
        nb = len(info["payload_off"])
        block_size = int(info["block_size"])
        total_len = int(info["total_len"])
        if nb == 0:  # before the device, as the reference returns
            return b""
    device = resolve_device(config.engine, config.device)

    with timer.phase("pre"):
        comp, comp_len, out_len = pipeline.blockize_compressed(stream, info)
        comp, comp_len, out_len = (torch.from_numpy(a) for a in (comp, comp_len, out_len))
        result = native.uninit_bytearray(total_len) if native.available() else bytearray(total_len)
        flat = torch.frombuffer(result, dtype=torch.uint8)

    batch = max(1, config.batch_blocks)
    count = -(-nb // batch)
    depth, sync, slots = _schedule(config, count)
    rows = min(batch, nb)
    cap = comp.shape[1]
    with timer.phase("compile"):
        if config.engine == "cuda":
            _build.load()
        ring = staging.acquire(device, slots, {
            "in": {"comp": ((rows, cap), torch.uint8), "comp_len": ((rows,), torch.int32),
                   "out_len": ((rows,), torch.int32)},
            "out": {"out": ((rows, block_size), torch.uint8), "err": ((rows,), torch.int32)},
        })
    decode = {
        "cuda": hopper_decode.decode_blocks, "torch": hopper_decode.decode_blocks_torch,
        "portable": _decode_portable,
    }[config.engine]

    def fetch(slot, n, out, err):  # enqueue the d2h copies on the slot's stream
        slot.mark("d2h")
        with slot.on_stream():
            slot.views["out"][:n].copy_(out, non_blocking=True)
            slot.views["err"][:n].copy_(err, non_blocking=True)
        slot.finish()

    def stage(i, slot):  # the host copy into the slot, once it is free
        start, stop = i * batch, min(nb, (i + 1) * batch)
        n = stop - start
        host = slot.views
        with timer.phase("h2d"):
            slot.take(i)
            host["comp"][:n].copy_(comp[start:stop])
            host["comp_len"][:n].copy_(comp_len[start:stop])
            host["out_len"][:n].copy_(out_len[start:stop])
        return start, stop

    def launch(i, slot, staged):
        start, stop = staged
        n = stop - start
        host = slot.views
        with timer.phase("h2d"):
            slot.mark("h2d")
            with slot.on_stream():
                args = [host[k][:n].to(device, non_blocking=True) for k in ("comp", "comp_len", "out_len")]
            if sync:
                slot.synchronize()
        with timer.phase("kernel"):
            with slot.on_stream():
                out, err = decode(*args, block_size=block_size)
            if sync:
                slot.synchronize()
            else:
                fetch(slot, n, out, err)
        return start, stop, args, out, err  # the device tensors live until the drain

    def drain(i, slot, held):
        start, stop, _, out, err = held
        n = stop - start
        host = slot.views
        with timer.phase("d2h"):
            if sync:
                fetch(slot, n, out, err)
            slot.ready()
            err_h = host["err"][:n]
            if config.validate and bool(err_h.any()):
                bad = int(torch.nonzero(err_h)[0, 0])
                raise SnappyError(
                    SnappyStatus.INVALID_INPUT,
                    f"block {start + bad} failed validation (flags={int(err_h[bad])})",
                )
            lo = start * block_size
            hi = min(stop * block_size, total_len)
            full = (hi - lo) // block_size
            flat[lo : lo + full * block_size].view(full, block_size).copy_(host["out"][:full])
            if lo + full * block_size < hi:  # final partial block
                flat[lo + full * block_size : hi].copy_(host["out"][full, : hi - lo - full * block_size])

    with ring:
        staging.run(ring, count, depth, stage, launch, drain)

    with timer.phase("post"):
        return bytes(result) if total_len < (1 << 20) else result


def compress(
    data: bytes,
    config: TorchCodecConfig | None = None,
    timer: PhaseTimer | None = None,
) -> bytes | bytearray:
    """Compress to a framed stream.

    The device engines blockize the input, divert incompressible blocks to
    raw literal frames (``config.raw_triage``), and encode the rest in
    batches of ``config.batch_blocks`` (plus a tail batch), each h2d ->
    match + emit -> d2h through a slot of the device's staging ring, with up
    to ``config.pipeline_depth`` batches in flight and the phases timed as
    ``decompress`` says. On the ``cuda`` and ``torch`` engines the sorted
    matcher in every mode (rung pick, ``sel_all`` select ladder, per-rung
    ladder; any rung strides and sort window) at 256 <= block_size <= 65536
    (a multiple of 128) is ported, with the reference's switch to the
    select ladder above 32768 (``timer.notes["wide_select"]``), and so is
    the sweep matcher (``matcher="sweep"``: ``match_window``,
    ``coarse_window``, sampled or granular ``coarse_mode``) at block_size
    <= 16384 (granular at multiples of 256). Outside that envelope
    (``hopper_encode.envelope_gap``), as the reference's ``pallas`` engine
    falls back to ``xla``, they warn, note
    ``timer.notes["engine_fallback"]`` and compress on the ``portable``
    engine on the same device, or raise ``SnappyError(BAD_ARGUMENT)``
    under ``config.strict_engine`` before any launch; a knob the
    reference refuses too raises (``hopper_encode.encode_knobs``). The
    ``portable`` engine takes every block size. Empty input
    gives the header-only stream before any of these checks, on every
    engine, with or without a device, as in the reference. With
    ``config.verify``, each batch is decoded again on its device and
    compared with its input blocks; a per-block flag comes back with the
    batch, and a mismatch raises ``SnappyError`` when the batch is drained,
    naming its failing blocks.
    """
    config = config or TorchCodecConfig()
    timer = timer if timer is not None else PhaseTimer()

    if config.engine == "oracle":
        with timer.phase("kernel"):
            return oracle.compress(data, config.block_size)
    if config.engine == "native":
        with timer.phase("kernel"):
            return native.compress(data, config.block_size, num_threads=config.num_threads)

    block_size = config.block_size
    if not data:  # the header-only stream, before the knobs and the device, as the reference returns it
        with timer.phase("pre"):
            return oracle.compress(b"", block_size)
    fallback = _envelope_fallback(config)
    engine = "portable" if fallback else config.engine
    select_notes: dict = {}
    knobs = hopper_encode.encode_knobs(config, select_notes) if engine != "portable" else {}
    device = resolve_device(config.engine, config.device)  # a fallback stays on the engine's device
    if fallback:
        gap, msg = fallback
        warnings.warn(msg, stacklevel=2)
        timer.notes["engine_fallback"] = f"{config.engine}->portable ({gap})"
    cap = pipeline.padded_capacity(block_size)

    with timer.phase("pre"):
        blocks, lens = pipeline.blockize_plain(data, block_size)
        nb = len(lens)
        raw = pipeline.triage_incompressible(blocks, lens) if config.raw_triage else np.zeros(nb, bool)
        dev_idx = np.flatnonzero(~raw)
        if nb - dev_idx.size:
            timer.notes["raw_blocks"] = int(nb - dev_idx.size)
        if dev_idx.size:  # as the reference, noted only where a batch runs
            timer.notes.update(select_notes)
        comp = np.empty((nb, cap), dtype=np.uint8)
        sizes = np.empty(nb, dtype=np.int32)
        blocks_t, lens_t, comp_t, sizes_t = (torch.from_numpy(a) for a in (blocks, lens, comp, sizes))

    batch = max(1, config.batch_blocks)
    count = -(-dev_idx.size // batch)
    depth, sync, slots = _schedule(config, count)
    rows = min(batch, dev_idx.size)
    with timer.phase("compile"):
        if engine == "cuda":
            _build.load()
        # No batch when the triage diverted every block: no device work at all.
        ring = staging.acquire(device, slots, {
            "in": {"blocks": ((rows, block_size), torch.uint8), "lens": ((rows,), torch.int32)},
            "out": {"comp": ((rows, cap), torch.uint8), "sizes": ((rows,), torch.int32),
                    "bad": ((rows,), torch.int32)},
        }) if count else None
    if engine == "cuda":
        encode, decode = functools.partial(hopper_encode.encode_blocks, cap=cap, **knobs), hopper_decode.decode_blocks
    elif engine == "torch":
        encode = functools.partial(hopper_encode.encode_blocks_torch, cap=cap, **knobs)
        decode = hopper_decode.decode_blocks_torch
    else:
        # Only block_size, as the reference's runtime calls it
        # (runtime/api.py:409-411): the defaults prev_k=2, sel_cap=16 make
        # the xla engine's stream, and any other value would move it.
        encode = functools.partial(encode_ops.encode_blocks, block_size=block_size)
        decode = decode_ops.decode_blocks

    def fetch(slot, n, comp_d, sizes_d, bad_d):  # enqueue the d2h copies on the slot's stream
        slot.mark("d2h")
        with slot.on_stream():
            slot.views["comp"][:n].copy_(comp_d, non_blocking=True)
            slot.views["sizes"][:n].copy_(sizes_d, non_blocking=True)
            if bad_d is not None:
                slot.views["bad"][:n].copy_(bad_d, non_blocking=True)
        slot.finish()

    def stage(i, slot):  # the host copy into the slot, once it is free
        idx = dev_idx[i * batch : (i + 1) * batch]
        runs = _runs(idx)
        host = slot.views
        with timer.phase("h2d"):
            slot.take(i)
            for at, first, length in runs:  # raw blocks split the batch's rows into runs
                host["blocks"][at : at + length].copy_(blocks_t[first : first + length])
                host["lens"][at : at + length].copy_(lens_t[first : first + length])
        return idx, runs

    def launch(i, slot, staged):
        idx, runs = staged
        n = idx.size
        host = slot.views
        with timer.phase("h2d"):
            slot.mark("h2d")
            with slot.on_stream():
                blocks_d = host["blocks"][:n].to(device, non_blocking=True)
                lens_d = host["lens"][:n].to(device, non_blocking=True)
            if sync:
                slot.synchronize()
        with timer.phase("kernel"):
            with slot.on_stream():
                comp_d, sizes_d = encode(blocks_d, lens_d)
                bad_d = None
                if config.verify:
                    out_v, err_v = decode(comp_d, sizes_d, lens_d, block_size=block_size)
                    inside = torch.arange(block_size, device=device)[None, :] < lens_d[:, None]
                    bad_d = (((out_v != blocks_d) & inside).any(dim=1) | (err_v != 0)).to(torch.int32)
            if sync:
                slot.synchronize()
            else:
                fetch(slot, n, comp_d, sizes_d, bad_d)
        return idx, runs, blocks_d, lens_d, comp_d, sizes_d, bad_d  # the device tensors live until the drain

    def drain(i, slot, held):
        idx, runs, _, _, comp_d, sizes_d, bad_d = held
        n = idx.size
        host = slot.views
        with timer.phase("d2h"):
            if sync:
                fetch(slot, n, comp_d, sizes_d, bad_d)
            slot.ready()
            for at, first, length in runs:
                comp_t[first : first + length].copy_(host["comp"][at : at + length])
                sizes_t[first : first + length].copy_(host["sizes"][at : at + length])
            if bad_d is not None and bool(host["bad"][:n].any()):
                failed = idx[np.flatnonzero(host["bad"][:n].numpy())]
                raise SnappyError(
                    SnappyStatus.INVALID_INPUT,
                    f"on-device verify failed for blocks {failed[:8].tolist()}",
                )

    if ring is not None:
        with ring:
            staging.run(ring, count, depth, stage, launch, drain)

    with timer.phase("post"):
        pipeline.raw_literal_frames(blocks, lens, comp, sizes, np.flatnonzero(raw))
        if config.validate and int(sizes.max(initial=0)) > cap:
            raise SnappyError(SnappyStatus.BUFFER_TOO_SMALL, "encoder overflow")
        return pipeline.assemble_compressed(comp, sizes, len(data), block_size)
