"""Closed-loop traffic through a device entry of the port, over batches that
sit in device memory.

The traffic file names the entry and its parameters:

- ``entry``: "decompress" drives ``ops.hopper_decode.decode_blocks`` on the
  compressed rows that set-up made from the working set with the port's
  own encode at the cell's configuration; "compress" drives
  ``ops.hopper_encode.encode_blocks`` on the working set's plaintext;
- ``in_flight``: batches enqueued ahead on one stream; batch ``i`` is
  enqueued once batch ``i - in_flight`` has completed (its event), and
  nothing synchronises the device inside the window;
- ``resident_mib``, ``base_mib``, ``text_seed``: the working set
  (``yardstick/working_set.py``), made on the device from one uploaded
  base and held there for the whole window, its batches driven in turn, in
  an order drawn from the seed.

Every block is full (``block_size`` bytes of plaintext). The window keeps
the answers of ``CHECK_BYTES`` of plaintext's worth of its calls, drawn
from the seed over all of them (a reservoir), and the sizes of every
compress call. After the window the plain reference judges the kept
answers (``check``).
"""

from __future__ import annotations

import dataclasses
import functools
import multiprocessing
import os
import random
import time

import numpy as np
import torch

from hopper_bench.yardstick import snappy_ref, work, working_set

# Every number compared is exact: its limit is 0.
LIMITS = {"decompress": {"bad_blocks": 0}, "compress": {"bad_blocks": 0}}
CHECK_BYTES = 256 * working_set.MIB  # plaintext of the answers a run keeps and checks
POOL_MIN_BLOCKS = 64  # fewer blocks are checked in this process
TASK_BLOCKS = 64  # blocks a pool task checks


@dataclasses.dataclass
class Record:
    """What the per-layer metrics' readers read of one run."""
    entry: str
    calls: int
    window_s: float  # host seconds from the first enqueue to the last completion
    enqueue_s: list  # host seconds inside the entry, per call
    function_bytes: int  # bytes the window's calls must move (``yardstick/work.py``)
    trace: object = None  # ``core.trace.Summary`` of a traced run


def _pool_map(fn, tasks: list, blocks: int) -> list:
    """``fn`` over ``tasks`` in worker processes (spawned, one a core up to
    8), or in this process for a few blocks."""
    if blocks < POOL_MIN_BLOCKS:
        return [fn(t) for t in tasks]
    procs = max(1, min(8, os.cpu_count() or 1))
    pool = multiprocessing.get_context("spawn").Pool(procs)
    try:
        return pool.map(fn, tasks)
    finally:
        pool.close()
        pool.join()


def _chunks(items: list, n: int = TASK_BLOCKS) -> list:
    return [items[i : i + n] for i in range(0, len(items), n)]


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, seconds: float):
        t, c = cell.traffic, cell.config["codec"]
        self.kind = t["entry"]
        if self.kind not in LIMITS:
            raise ValueError(f"entry must be one of {sorted(LIMITS)}, not {self.kind!r}")
        self.seed, self.device, self.seconds = seed, device, seconds
        self.in_flight = int(t["in_flight"])
        self.text_seed = int(t["text_seed"])
        self.codec = c
        self.layout = working_set.Layout(
            block_size=int(c["block_size"]), batch_blocks=int(c["batch_blocks"]),
            resident_bytes=int(t["resident_mib"] * working_set.MIB), base_bytes=int(t["base_mib"] * working_set.MIB),
        )
        self.check_calls = max(1, CHECK_BYTES // self.layout.batch_bytes)
        self.kept: list = []

    # -- set-up ---------------------------------------------------------

    def setup(self, phase) -> None:
        L = self.layout
        with phase("generate"):
            self.base = working_set.base_text(L, self.text_seed)
            self.perms = working_set.permutations(L, self.seed)
            self.order = working_set.batch_order(L, self.seed)
        with phase("context"):
            from pim_compression_tpu_torch import TorchCodecConfig
            from pim_compression_tpu_torch.ops import _build, hopper_decode, hopper_encode
            from pim_compression_tpu_torch.runtime import pipeline

            if self.device.type == "cuda":
                torch.cuda.init()
                torch.zeros(1, device=self.device)
                _build.load()
            config = TorchCodecConfig(**self.codec)
            self.cap = pipeline.padded_capacity(L.block_size)
            self.encode = functools.partial(hopper_encode.encode_blocks, cap=self.cap, **hopper_encode.encode_knobs(config))
        with phase("upload"):
            index = torch.from_numpy(self.base.copy()).to(self.device).long()
            perms = torch.from_numpy(self.perms).to(self.device)
            self.lens = torch.full((L.batch_blocks,), L.block_size, dtype=torch.int32, device=self.device)

        def fill(b: int, out: torch.Tensor) -> torch.Tensor:
            flat, at = out.view(-1), 0
            for j, s, e in L.pieces(b):
                torch.index_select(perms[j], 0, index[s:e], out=flat[at : at + e - s])
                at += e - s
            return out

        shape = (L.batch_blocks, L.block_size)
        if self.kind == "decompress":
            with phase("store"):
                # The rows users would store: the port's encode of every batch.
                scratch = torch.empty(shape, dtype=torch.uint8, device=self.device)
                made = [self.encode(fill(b, scratch), self.lens) for b in range(L.batches)]
                self.comp_len_sum = [int(x) for x in torch.stack([s for _, s in made]).sum(dim=1).tolist()]
                self.args = [(c, n, self.lens) for c, n in made]
                self.entry = functools.partial(hopper_decode.decode_blocks, block_size=L.block_size)
                del made, scratch
        else:
            with phase("fill"):
                plain = torch.empty((L.batches, *shape), dtype=torch.uint8, device=self.device)
                self.args = [(fill(b, plain[b]), self.lens) for b in range(L.batches)]
                self.entry = self.encode
                del plain
        del index, perms
        with phase("warmup"):
            # As many answers held at once as the window holds (those in
            # flight and those kept), so that the allocator has them cached.
            n = len(self.args)
            held = [self.entry(*self.args[self.order[k % n]]) for k in range(self.in_flight + min(self.check_calls, n) + 1)]
            self._sync()
            start = time.perf_counter()
            for k in range(self.in_flight):
                self.entry(*self.args[self.order[k % n]])
            self._sync()
            per_call = (time.perf_counter() - start) / self.in_flight
            if self.kind == "compress":
                # Room in the allocator's cache for every call's sizes.
                spare = [torch.empty_like(self.lens) for _ in range(int(self.seconds / max(per_call, 1e-5) * 1.5) + 64)]
                del spare
            del held
            self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window -----------------------------------------------------

    def window(self, seconds: float, span, entry=None, max_calls: int | None = None) -> Record:
        """Drive the entry (or ``entry`` in its place) for ``seconds``, or
        for ``max_calls`` calls, with ``in_flight`` batches enqueued."""
        entry = entry or self.entry
        n, depth, keep = len(self.args), self.in_flight, self.check_calls
        cuda = self.device.type == "cuda"
        events = [torch.cuda.Event() for _ in range(depth)] if cuda else []
        pending = [False] * depth
        draw = random.Random(self.seed).randrange
        kept: list = []  # (call, batch, answer)
        sizes: list = []
        enqueue: list = []
        i = 0
        with span("window"):
            t0 = time.perf_counter()
            while True:
                slot = i % depth
                if pending[slot]:
                    with span("wait"):
                        events[slot].synchronize()
                    pending[slot] = False
                if (max_calls is None and time.perf_counter() - t0 >= seconds) or i == max_calls:
                    break
                b = self.order[i % n]
                s = time.perf_counter()
                with span("enqueue"):
                    out = entry(*self.args[b])
                enqueue.append(time.perf_counter() - s)
                if cuda:
                    events[slot].record()
                    pending[slot] = True
                if i < keep:
                    kept.append((i, b, out))
                else:
                    k = draw(i + 1)
                    if k < keep:
                        kept[k] = (i, b, out)
                if self.kind == "compress":
                    sizes.append(out[1])
                del out
                i += 1
            for slot in range(depth):
                if pending[slot]:
                    with span("wait"):
                        events[slot].synchronize()
            t1 = time.perf_counter()
        self.kept, self.sizes, self.calls = kept, sizes, i
        L = self.layout
        if self.kind == "decompress":
            fbytes = sum(work.decode_bytes(self.comp_len_sum[self.order[k % n]], L.batch_bytes, L.batch_blocks)
                         for k in range(i))
        else:
            self.sizes_sum = int(torch.stack(sizes).sum()) if sizes else 0
            fbytes = i * work.encode_bytes(L.batch_bytes, 0, L.batch_blocks) + self.sizes_sum
        return Record(entry=self.kind, calls=i, window_s=t1 - t0, enqueue_s=enqueue, function_bytes=fbytes)

    def end_to_end(self, rec: Record) -> dict:
        """The window's end-to-end numbers: GB/s of plaintext, and for
        compress the ratio of the framed stream its outputs make."""
        L = self.layout
        plain = rec.calls * L.batch_bytes
        gbps = plain / rec.window_s / 1e9 if rec.window_s > 0 else 0.0
        if self.kind == "decompress":
            return {"decompress_gbps": gbps}
        framed = snappy_ref.framed_bytes(plain, L.block_size, self.sizes_sum, rec.calls * L.batch_blocks)
        return {"compress_gbps": gbps, "compress_ratio": plain / framed}

    # -- after the window -----------------------------------------------

    def collect(self) -> None:
        """Copy the kept answers to the host, for ``check``: for compress,
        with each block marked where some call of the same batch in the
        window gave it another size than the kept answer."""
        n = len(self.args)
        host = []
        if self.kind == "compress" and self.sizes:
            every = torch.stack(self.sizes)
            batch_of = torch.tensor([self.order[k % n] for k in range(self.calls)], device=every.device)
        for c, b, out in self.kept:
            got = tuple(t.cpu().numpy() for t in out)
            if self.kind == "compress":
                other = (every[batch_of == b] != out[1]).any(dim=0).cpu().numpy()
                got = (*got, other)
            host.append((b, got))
        self.kept_host = host
        self.sizes = []

    def release(self) -> None:
        """Free the program's state on the device."""
        for name in ("kept", "sizes", "args", "lens", "entry", "encode"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers compared, each with its limit: {name: (value, limit)};
        ``self.failed`` counts the kept answers found wrong."""
        if not self.kept_host:  # the window made no call
            values, failed = {"bad_blocks": self.layout.batch_blocks}, 1
        elif self.kind == "decompress":
            values, failed = self._check_decompress()
        else:
            values, failed = self._check_compress()
        self.failed = failed
        limits = LIMITS[self.kind]
        return {k: (values[k], limits[k]) for k in limits}

    def _plain(self, b: int) -> np.ndarray:
        return working_set.batch_plain(self.layout, self.base, self.perms, b)

    def _bad_streams(self, comps: list, digests: list) -> list:
        """Indices of the streams the plain decoder does not decode to the
        plaintext of their digest."""
        L = self.layout
        tasks = [(c, [L.block_size] * len(c), d) for c, d in zip(_chunks(comps), _chunks(digests))]
        found = _pool_map(snappy_ref.check_blocks, tasks, len(comps))
        return [t * TASK_BLOCKS + k for t, ks in enumerate(found) for k in ks]

    def _check_decompress(self) -> tuple[dict, int]:
        """Every block of the kept answers against the plaintext, which the
        reference makes again from the seed: a block is bad where a byte
        differs or its verdict is not 0."""
        bad_blocks = failed = 0
        for b, (out, err) in self.kept_host:
            bad = int(np.count_nonzero((out != self._plain(b)).any(axis=1) | (err != 0)))
            bad_blocks += bad
            failed += bad > 0
        return {"bad_blocks": bad_blocks}, failed

    def _check_compress(self) -> tuple[dict, int]:
        """Every block of the kept answers through the plain decoder: its
        stream, cut to its size, has to decode to its plaintext, and every
        call of its batch in the window has to have given it that size."""
        L = self.layout
        bad = [set() for _ in self.kept_host]
        comps, digests, owners = [], [], []
        for a, (b, (rows, sizes, other)) in enumerate(self.kept_host):
            want = self._plain(b)
            bad[a].update(np.flatnonzero(other).tolist())
            for k in range(L.batch_blocks):
                n = int(sizes[k])
                if not 0 <= n <= rows.shape[1]:
                    bad[a].add(k)
                    continue
                comps.append(rows[k, :n].tobytes())
                digests.append(snappy_ref.digest(want[k].tobytes()))
                owners.append((a, k))
        for x in self._bad_streams(comps, digests):
            a, k = owners[x]
            bad[a].add(k)
        return {"bad_blocks": sum(map(len, bad))}, sum(1 for s in bad if s)
