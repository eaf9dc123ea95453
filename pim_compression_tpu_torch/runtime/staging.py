"""Host staging for the device engines: a ring of batch slots on one device.

The JAX runtime needs no counterpart of this module: ``jax.device_put`` and
XLA's asynchronous dispatch let the h2d copy and the kernels of one batch
run while the batch before it comes back (``pim_compression_tpu/runtime/
api.py``, the bounded-depth pipelining of ``decompress`` and ``compress``).
On CUDA a copy between pageable host memory and the device blocks the host,
so the same schedule written naively overlaps nothing. The port's
counterpart is a ring of slots, one batch in flight in each:

- a CUDA stream, on which the batch's h2d copy, kernels and d2h copy run in
  order (every kernel wrapper launches on the current stream);
- pinned host buffers for one batch in and one batch out, carved from two
  arenas (``Slot.views``);
- an event recorded after the d2h copy: the batch is back on the host once
  it has completed, and the slot may be reused.

``run`` is the schedule: batch ``i`` in slot ``i % slots``, at most
``depth`` batches in flight, drained in launch order, each batch's input
staged into its slot as soon as the slot is free. Rings are pooled per
device and grown only when a call needs more slots or larger buffers, so a
repeated call pays no new pinned allocation. On the CPU (the ``torch``
engine there) the same schedule runs with plain host buffers and no streams.
A pinned allocation that fails raises ``SnappyError``; nothing continues on
pageable memory.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable

import torch

from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

_ALIGN = 256  # bytes between the views carved from one arena

# When a list, every slot on a CUDA device appends (batch, mark, event) with a
# timing event recorded on its stream at each mark; None (the default) records
# nothing. ``chip_smoke.py`` reads it to show that batches overlap.
TIMELINE: list | None = None

# Free rings by device: a call takes one (or makes one, if another thread's
# call holds the last) and gives it back when its batches are drained.
_POOL: dict[str, list["Ring"]] = {}
_POOL_LOCK = threading.Lock()


def _pinned_empty(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _host_buffer(device: torch.device, nbytes: int) -> torch.Tensor:
    """A flat uint8 host buffer: pinned for a CUDA device, plain for the CPU."""
    if device.type != "cuda":
        return torch.empty(nbytes, dtype=torch.uint8)
    try:
        buf = _pinned_empty(nbytes)
    except RuntimeError as e:
        raise SnappyError(
            SnappyStatus.BUFFER_TOO_SMALL, f"pinned host staging of {nbytes} bytes failed: {e}"
        ) from e
    if not buf.is_pinned():
        raise SnappyError(SnappyStatus.BUFFER_TOO_SMALL, f"host staging of {nbytes} bytes is not pinned")
    return buf


def _layout(spec: dict) -> tuple[dict, int]:
    """Byte offsets of each (shape, dtype) view in one arena, and its size."""
    offsets, size = {}, 0
    for name, (shape, dtype) in spec.items():
        offsets[name] = size
        size += -(-torch.Size(shape).numel() * dtype.itemsize // _ALIGN) * _ALIGN
    return offsets, size


class Slot:
    """One batch in flight: a stream, host views in and out, a done event."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.done = torch.cuda.Event() if cuda else None
        self.arenas: dict[str, torch.Tensor] = {}
        self.views: dict[str, torch.Tensor] = {}
        self.batch: int | None = None  # the batch the slot holds

    def fit(self, spec: dict[str, dict]) -> None:
        """Carve ``views`` from the arenas, growing an arena that is too small.
        ``spec`` maps an arena ("in", "out") to {name: (shape, dtype)}."""
        self.views = {}
        for arena, fields in spec.items():
            offsets, size = _layout(fields)
            buf = self.arenas.get(arena)
            if buf is None or buf.numel() < size:
                buf = self.arenas[arena] = _host_buffer(self.device, size)
            for name, (shape, dtype) in fields.items():
                nbytes = torch.Size(shape).numel() * dtype.itemsize
                self.views[name] = buf[offsets[name] : offsets[name] + nbytes].view(dtype).view(shape)

    def on_stream(self):
        """Context in which device work and allocations go to the slot's stream."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def take(self, batch: int) -> None:
        """Hold ``batch``: first wait until the batch before it in this slot
        is back on the host, since its copies read and write these views."""
        if self.done is not None:
            self.done.synchronize()
        self.batch = batch

    def mark(self, name: str) -> None:
        """A timing event on the slot's stream, when ``TIMELINE`` is a list."""
        if TIMELINE is not None and self.stream is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record(self.stream)
            TIMELINE.append((self.batch, name, event))

    def finish(self) -> None:
        """Mark the batch's d2h copies, enqueued on the slot's stream, as its last work."""
        if self.done is not None:
            self.done.record(self.stream)
        self.mark("done")

    def ready(self) -> int | None:
        """Wait until the batch's d2h copies have completed; the batch it held."""
        if self.done is not None:
            self.done.synchronize()
        return self.batch

    def synchronize(self) -> None:
        """Wait for all work on the slot's stream (the synchronous mode's phase ends)."""
        if self.stream is not None:
            self.stream.synchronize()


class Ring:
    """The slots of one device; a context manager that returns it to the pool."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.slots: list[Slot] = []
        self.active = 0  # the slots the current call uses

    def fit(self, slots: int, spec: dict[str, dict]) -> None:
        while len(self.slots) < slots:
            self.slots.append(Slot(self.device))
        for slot in self.slots[:slots]:
            slot.fit(spec)
        self.active = slots

    def __enter__(self) -> "Ring":
        return self

    def __exit__(self, *exc) -> None:
        # Every slot's stream, whatever happened: no copy still in flight may
        # write into a buffer that the next call reuses. A failed sync keeps
        # the ring out of the pool.
        for slot in self.slots:
            if slot.stream is not None:
                slot.stream.synchronize()
            slot.batch = None
        with _POOL_LOCK:
            _POOL.setdefault(str(self.device), []).append(self)


def acquire(device: torch.device, slots: int, spec: dict[str, dict]) -> Ring:
    """A ring of ``slots`` slots on ``device`` whose views have ``spec``'s
    shapes: a pooled one if there is one (grown as needed), else a new one.
    On a CUDA device the first call creates the streams and pins the buffers."""
    with _POOL_LOCK:
        free = _POOL.get(str(device))
        ring = free.pop() if free else None
    ring = ring or Ring(device)
    ring.fit(slots, spec)
    return ring


def run(ring: Ring, count: int, depth: int, stage: Callable, launch: Callable, drain: Callable) -> None:
    """The JAX runtime's bounded-depth schedule: launch batches 0..count-1
    in order, batch i in slot ``i % ring.active`` (``launch(i, slot,
    staged)`` returns what its drain needs); once ``depth`` batches are in
    flight, drain the oldest (``drain(i, slot, held)``); at the end drain
    the rest in launch order. A batch's host input is staged (``stage(i,
    slot)`` returns ``staged``) as soon as its slot is free, that is once
    the batch before it in the slot is drained: the ring fills with staged
    batches before the first launch, so the first launches follow each other
    with no host copy between them and their device work overlaps."""
    inflight: collections.deque = collections.deque()
    staged: dict[int, object] = {}
    ahead = drained = 0
    for i in range(count):
        while ahead < count and ahead - ring.active < drained:
            staged[ahead] = stage(ahead, ring.slots[ahead % ring.active])
            ahead += 1
        slot = ring.slots[i % ring.active]
        inflight.append((i, slot, launch(i, slot, staged.pop(i))))
        if len(inflight) >= depth:
            drain(*inflight.popleft())
            drained += 1
    while inflight:
        drain(*inflight.popleft())


def overlap_ms(timeline: list) -> list[float]:
    """From the ``TIMELINE`` of one call: for each batch i but the last, how
    long batch i+1's h2d copy and kernels ran before batch i's d2h copies
    had completed, in ms (0 where batch i+1 started after them)."""
    marks = {(batch, name): event for batch, name, event in timeline}
    for event in marks.values():
        event.synchronize()
    count = 1 + max(batch for batch, _ in marks)
    return [
        max(0.0, min(marks[i + 1, "h2d"].elapsed_time(marks[i, "done"]),
                     marks[i + 1, "h2d"].elapsed_time(marks[i + 1, "d2h"])))
        for i in range(count - 1)
    ]
