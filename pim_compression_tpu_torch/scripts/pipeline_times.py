"""Each device pipeline's slope per 128-block group, beside the work ledger's bound for the same blocks.

    python -m pim_compression_tpu_torch.scripts.pipeline_times [--device cuda:0] [--config NAME ...]
        [--iters 5] [--corpus DIR] [--out PATH]

The counterpart of the JAX package's ``scripts/device_pipeline_times.py``,
which set each pipeline's device slope beside the op ledger's projection
and their residual. For the decompress and compress pipelines at 32 KB
and 64 KB in the zero-flag config, and the compress at 8 KB with the sweep
(``CONFIGS``), it runs ``runtime.devbench.slope_measure`` on the ``cuda``
engine (G=1 and G=8: 128 and 1024 device-resident blocks of
``chip_smoke.py``'s seeded text or the ``--corpus`` texts; the slope
``(t_G8 - t_G1) / 7`` is the device time of one more group of 128 blocks)
and counts with the work ledger the work of the same 7 x 128 blocks
(blocks 128-1023 of the G=8 batch: the decode's, or the matcher's and the
emit's, whose bounds add since the two kernels run in turn). Per pipeline:
the slope's GB/s, the bound's GB/s, and their ratio (the share of the
bound the pipeline reaches: the JAX script's measured-vs-projected
residual). Runs on the card only: without one it raises. Writes
``build/tooling/pipeline_times.json`` and prints one line per pipeline.
"""

from __future__ import annotations

import argparse
import json

import torch

from pim_compression_tpu_torch import TorchCodecConfig, native
from pim_compression_tpu_torch.ops import hopper_match, hopper_sweep
from pim_compression_tpu_torch.runtime import devbench, pipeline
from pim_compression_tpu_torch.scripts import common, tooling, work_ledger

# Port config -> the directions timed.
CONFIGS = {
    "32768 zero-flag": ("decompress", "compress"),
    "65536 zero-flag": ("decompress", "compress"),
    "8192 sweep": ("compress",),
}


def group_bounds(plain: bytes, name: str, dev) -> dict:
    """The work ledger's bounds, per 128-block group, of blocks 128-1023 of
    the batch ``slope_measure`` cuts from ``plain`` for a port config."""
    bs, knobs = work_ledger.port_knobs(name)
    knobs = dict(knobs)
    sweep = knobs.pop("matcher") == "sweep"
    lanes, groups = devbench.LANES, devbench.GROUPS
    need = bs * lanes * groups
    plain = (plain * -(-need // len(plain)))[:need]
    blocks_np, lens_np = pipeline.blockize_plain(plain, bs)
    stream = native.compress(plain, bs)
    _, clen, olen = pipeline.blockize_compressed(stream, pipeline.scan_frames(stream))
    extra = slice(lanes, None)
    blocks, lens = (torch.from_numpy(a[extra].copy()).to(dev) for a in (blocks_np, lens_np))
    if sweep:
        mlen, mlag = hopper_sweep.sweep_match(blocks, lens, **knobs)
        match = work_ledger.sweep_work(blocks, lens, mlen, mlag, knobs)
    else:
        match = work_ledger.match_work(hopper_match.match_blocks(blocks, lens, **knobs)[0], knobs)
    emit = work_ledger.emit_work(lens_np[extra], bs, pipeline.padded_capacity(bs))
    per = groups - 1
    return {
        "decompress": {"decode": work_ledger.decode_work(clen[extra], olen[extra], bs)["bound_ms"] / per},
        "compress": {"sweep" if sweep else "match": match["bound_ms"] / per, "emit": emit["bound_ms"] / per},
    }


def run(device="cuda:0", names=None, iters: int = 5, corpus=None, payloads: dict | None = None) -> dict:
    """A record per (config, direction): the slope, the bound, their ratio."""
    dev = common.cuda_device(device)
    torch.cuda.set_device(dev)
    cache = payloads if payloads is not None else {}
    names = list(CONFIGS) if names is None else list(names)
    common.warm(dev)
    out = {"card": common.card(dev), "iters": iters, "records": []}
    for name in names:
        bs, fields = work_ledger.PORT_CONFIGS[name]
        plain = work_ledger.payload_for(bs, corpus, cache)
        slope = devbench.slope_measure(plain, TorchCodecConfig(engine="cuda", device=dev, block_size=bs, **fields),
                                       iters=iters)
        bounds = group_bounds(plain, name, dev)
        group_bytes = bs * devbench.LANES
        for direction in CONFIGS.get(name, ("decompress", "compress")):
            s = slope["decode" if direction == "decompress" else "encode"]
            bound_ms = sum(bounds[direction].values())
            bound_gbps = group_bytes / bound_ms / 1e6
            out["records"].append({
                "config": name, "direction": direction, "bs": bs, **s, "bound_ms_per_group": bound_ms,
                "bound_ms_per_group_by_kernel": bounds[direction], "bound_gbps": bound_gbps,
                "slope_over_bound": s["device_gbps"] / bound_gbps if s["device_gbps"] else None,
            })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pim_compression_tpu_torch.scripts.pipeline_times",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0", help="the CUDA device to measure (default cuda:0)")
    ap.add_argument("--config", action="append", default=None, help=f"one of {list(CONFIGS)} (repeatable)")
    ap.add_argument("--iters", type=int, default=5, help="timed calls of each size (best of)")
    tooling.add_corpus_arg(ap)
    ap.add_argument("--out", default="build/tooling/pipeline_times.json")
    args = ap.parse_args(argv)
    result = run(args.device, args.config, args.iters, args.corpus)
    for r in result["records"]:
        gbps = f"{r['device_gbps']:.3f}" if r["device_gbps"] else "none (no slope)"
        ratio = f"{r['slope_over_bound']:.4f}" if r["slope_over_bound"] else "none"
        print(f"{r['config']} {r['direction']}: slope {r['per_group_s'] * 1e3:.4f} ms a group, {gbps} GB/s; "
              f"bound {r['bound_ms_per_group']:.4f} ms, {r['bound_gbps']:.1f} GB/s; ratio {ratio}")
    path = tooling.output_path(args.out)
    path.write_text(json.dumps(result, indent=2) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
