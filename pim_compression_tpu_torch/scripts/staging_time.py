"""Time the host staging of one main-path batch: where the host copies go.

    python3 -m pim_compression_tpu_torch.scripts.staging_time [--device cuda:0]

The runtime stages each batch through pinned host buffers
(``runtime.staging``): a host copy into the slot, a pinned h2d copy, the
kernels, a pinned d2h copy, a host copy out of the slot. This script times
each of those steps on one 1024-block batch at bs 32768 (the main paths'
batch: 1024 rows of 38272 padded compressed bytes and of 32768 plain
bytes), the ways of making each host copy (PyTorch's ``copy_``, whole or
per run of rows between raw blocks, ``index_select`` and ``index_copy_``,
numpy, the native codec's parallel row copy; into a result touched before
and into a fresh one, whose pages the copy touches first), the pageable
copies the runtime made before, and the other design: ``cudaHostRegister``
on a fresh result buffer, so that the d2h copy lands in it directly, paid
on every call because every call has a new result. Each time is the
fastest of 5 host-clock runs that end synchronised. Writes
``build/probes/staging_time.json`` and prints one JSON line.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from pim_compression_tpu_torch import native
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import common
from pim_compression_tpu_torch.utils import streams

SEED = 20261016
BS = 32768
ROWS = 1024
RAW = (3, 100, 333, 512, 777, 1023)  # rows the triage would divert, as in chip_smoke's payload


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    card = common.card(dev)
    common.warm(dev)
    cap = pipeline.padded_capacity(BS)
    data = streams.text_payload((ROWS + len(RAW)) * BS, SEED)
    blocks, lens = pipeline.blockize_plain(data, BS)
    idx = torch.from_numpy(np.setdiff1d(np.arange(len(lens)), RAW)[:ROWS])
    rng = np.random.default_rng(SEED)
    comp = rng.integers(0, 256, (ROWS, cap), dtype=np.uint8)  # what blockize_compressed leaves in ``pre``
    blocks_t, comp_t = torch.from_numpy(blocks), torch.from_numpy(comp)
    slot_in = torch.empty((ROWS, cap), dtype=torch.uint8, pin_memory=True)
    slot_out = torch.empty((ROWS, cap), dtype=torch.uint8, pin_memory=True)
    result = native.uninit_bytearray(ROWS * BS) if native.available() else bytearray(ROWS * BS)
    flat = torch.frombuffer(result, dtype=torch.uint8).view(ROWS, BS)
    comp_all = torch.empty((len(lens), cap), dtype=torch.uint8)
    idx_np, comp_all_np = idx.numpy(), comp_all.numpy()
    on_dev = {"comp": comp_t.to(dev), "plain": blocks_t[:ROWS].to(dev)}
    torch.cuda.synchronize(dev)

    def sync(fn):
        def timed():
            fn()
            torch.cuda.synchronize(dev)
        return timed

    slot_plain = slot_in.view(-1)[: ROWS * BS].view(ROWS, BS)  # compress's input rows
    out_plain = slot_out.view(-1)[: ROWS * BS].view(ROWS, BS)  # decompress's output rows
    padded, plain = ROWS * cap, ROWS * BS

    starts = np.concatenate([[0], np.flatnonzero(np.diff(idx_np) != 1) + 1])
    runs = list(zip(starts.tolist(), idx_np[starts].tolist(), np.diff(np.append(starts, ROWS)).tolist()))

    def runs_into_slot():  # the runtime's way: one copy_ per run of rows between raw blocks
        for at, first, length in runs:
            slot_plain[at : at + length].copy_(blocks_t[first : first + length])

    def runs_out_of_slot():
        for at, first, length in runs:
            comp_all[first : first + length].copy_(slot_out[at : at + length])

    def fresh_result():  # every call returns a new buffer: its pages are first touched here
        fresh = native.uninit_bytearray(plain) if native.available() else bytearray(plain)
        torch.frombuffer(fresh, dtype=torch.uint8).view(ROWS, BS).copy_(out_plain)

    def scatter_from_slot():
        comp_all_np[idx_np] = slot_out.numpy()

    def pageable_then_scatter():
        comp_all_np[idx_np] = on_dev["comp"].cpu().numpy()

    cases = [
        # Decompress: padded rows in, blocks out.
        ("decompress in: copy_ into the slot", padded, lambda: slot_in.copy_(comp_t)),
        ("decompress h2d: from the pinned slot", padded, sync(lambda: slot_in.to(dev, non_blocking=True))),
        ("decompress h2d: pageable (the parent's)", padded, sync(lambda: comp_t.to(dev))),
        ("decompress d2h: into the pinned slot", plain,
         sync(lambda: out_plain.copy_(on_dev["plain"], non_blocking=True))),
        ("decompress out: copy_ from the slot into the result", plain, lambda: flat.copy_(out_plain)),
        ("decompress out: copy_ from the slot into a fresh result", plain, fresh_result),
        ("decompress d2h: pageable into the result (the parent's)", plain, sync(lambda: flat.copy_(on_dev["plain"]))),
        # Compress: gathered blocks in, padded rows out.
        ("compress in: copy_ per run of rows into the slot", plain, runs_into_slot),
        ("compress in: index_select into the slot", plain, lambda: torch.index_select(blocks_t, 0, idx, out=slot_plain)),
        ("compress in: numpy take into the slot", plain, lambda: np.take(blocks, idx_np, axis=0, out=slot_plain.numpy())),
        ("compress h2d: from the pinned slot", plain, sync(lambda: slot_plain.to(dev, non_blocking=True))),
        ("compress h2d: pageable gather (the parent's)", plain, sync(lambda: torch.from_numpy(blocks[idx_np]).to(dev))),
        ("compress d2h: into the pinned slot", padded, sync(lambda: slot_out.copy_(on_dev["comp"], non_blocking=True))),
        ("compress out: copy_ per run of rows from the slot", padded, runs_out_of_slot),
        ("compress out: index_copy_ from the slot", padded, lambda: comp_all.index_copy_(0, idx, slot_out)),
        ("compress out: numpy scatter from the slot", padded, scatter_from_slot),
        ("compress d2h: pageable, then scatter (the parent's)", padded, sync(pageable_then_scatter)),
    ]
    if native.available():
        off = idx_np.astype(np.int64) * BS
        rows_lens = lens[idx_np].astype(np.uint32)
        cases += [
            ("compress in: native row copy from the input into the slot", plain,
             lambda: native.blockize_compressed(data, off, rows_lens, slot_plain.numpy(), plain)),
            ("decompress out: native parallel copy from the slot", plain,
             lambda: native.parallel_copy(result, out_plain.numpy())),
        ]

    # The other design: register the result buffer and copy into it. Every
    # call has a new result, so every call pays the register and unregister.
    cudart = torch.cuda.cudart()

    def check(rc, what):
        if int(rc) != 0:
            raise RuntimeError(f"{what} failed: CUDA error {int(rc)}")

    def register_and_unregister():
        check(cudart.cudaHostRegister(flat.data_ptr(), plain, 0), "cudaHostRegister")
        check(cudart.cudaHostUnregister(flat.data_ptr()), "cudaHostUnregister")

    def registered_call():  # into a fresh result, as a call would
        fresh = native.uninit_bytearray(plain) if native.available() else bytearray(plain)
        dst = torch.frombuffer(fresh, dtype=torch.uint8).view(ROWS, BS)
        check(cudart.cudaHostRegister(dst.data_ptr(), plain, 0), "cudaHostRegister")
        dst.copy_(on_dev["plain"], non_blocking=True)
        torch.cuda.synchronize(dev)
        check(cudart.cudaHostUnregister(dst.data_ptr()), "cudaHostUnregister")

    cases += [
        ("decompress: cudaHostRegister + cudaHostUnregister of the result", plain, register_and_unregister),
        ("decompress d2h: register a fresh result, copy into it, unregister", plain, registered_call),
    ]
    out = [
        {"case": name, "s": common.host_seconds(fn), "bytes": nbytes, "threads": torch.get_num_threads(), "card": card}
        for name, nbytes, fn in cases
    ]
    for rec in out:
        rec["gb_per_s"] = rec["bytes"] / rec["s"] / 1e9
    print(json.dumps({"staging_time": {r["case"]: round(r["s"] * 1e3, 4) for r in out}}))
    return out


if __name__ == "__main__":
    sys.exit(common.main("staging_time", run, __doc__.splitlines()[0]))
