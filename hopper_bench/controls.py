"""The readings the comparison's limits are set from, on the card.

    python hopper_bench/controls.py --workload <name> --seeds 1,2,3

For each seed, one set-up, then for each variant as many calls as a run
keeps answers of (``CHECK_BYTES`` of plaintext, every one kept), each
judged by the cell's own comparison; one JSON line a variant and seed. The
variants:

- ``program``: the entry as the benchmark drives it (the lower reading);
- ``control``: the plain reference in the program's place, with one of the
  configuration's guarantees broken: for decompress the plain decoder
  copying each element from a snapshot of what it has written (a copy whose
  offset is below its length, a run, reads zeros past the snapshot); for
  compress the plain encoder trusting a 16-bit hash of the 4-byte word
  without comparing the words (a collision becomes a wrong copy);
- ``stale``, ``half``, ``altered``: the program with a fault planted
  (``core/faults.py``).

The benchmark's own runs never run this.
"""

import argparse
import json
import multiprocessing
import os
import pathlib
import sys
import time

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
CONTROL_KEY_BITS = 16


def control_entry(kind: str, pool, cap: int, block_size: int):
    """The plain reference with a guarantee broken, in the entry's place."""
    import numpy as np
    import torch

    from hopper_bench.yardstick import snappy_ref

    def chunks(items, n=64):
        return [items[i : i + n] for i in range(0, len(items), n)]

    def decode(comp, comp_len, out_len):
        rows, lens, outs = comp.cpu().numpy(), comp_len.cpu().numpy(), out_len.cpu().numpy()
        comps = snappy_ref.rows_to_bytes(rows, lens)
        parts = pool.map(snappy_ref.decode_task, [(c, o, False) for c, o in zip(chunks(comps), chunks(list(outs)))])
        plain = np.zeros((rows.shape[0], block_size), np.uint8)
        for k, b in enumerate(x for part in parts for x in part):
            plain[k, : len(b)] = np.frombuffer(b, np.uint8)
        return torch.from_numpy(plain).to(comp.device), torch.zeros_like(comp_len)

    def encode(blocks, lens):
        rows = snappy_ref.rows_to_bytes(blocks.cpu().numpy(), lens.cpu().numpy())
        parts = pool.map(snappy_ref.encode_task, [(c, CONTROL_KEY_BITS, False) for c in chunks(rows)])
        comp = np.zeros((len(rows), cap), np.uint8)
        sizes = np.zeros(len(rows), np.int32)
        for k, c in enumerate(x for part in parts for x in part):
            n = min(len(c), cap)
            comp[k, :n] = np.frombuffer(c, np.uint8)[:n]
            sizes[k] = len(c)
        return torch.from_numpy(comp).to(blocks.device), torch.from_numpy(sizes).to(blocks.device)

    return decode if kind == "decompress" else encode


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from hopper_bench.core import cells, faults, harness
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("controls.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    pool = multiprocessing.get_context("spawn").Pool(max(1, min(8, os.cpu_count() or 1)))
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            driver = cells.load_driver(cell).Driver(cell, seed, device, 1.0)
            phases = harness.Phases()
            driver.setup(phases)
            for name in ("program", "control", *faults.FAULTS):
                if name == "program":
                    entry = driver.entry
                elif name == "control":
                    entry = control_entry(driver.kind, pool, driver.cap, driver.layout.block_size)
                else:
                    entry = faults.FAULTS[name](driver.kind, driver.entry)
                start = time.perf_counter()
                rec = driver.window(0.0, harness.null_span, entry=entry, max_calls=driver.check_calls)
                driver.collect()
                checks = driver.check()
                print(json.dumps({
                    "workload": cell.name, "seed": seed, "variant": name, "calls": rec.calls,
                    "correct": all(v <= lim for v, lim in checks.values()),
                    "checks": {k: v for k, (v, _) in checks.items()},
                    "seconds": time.perf_counter() - start,
                }), flush=True)
            driver.release()
            del driver
    finally:
        pool.close()
        pool.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
