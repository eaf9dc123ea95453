"""Each kernel's and each span of glue's device time inside one codec call, on full batches.

    python -m pim_compression_tpu_torch.scripts.kernel_attrib [--device cuda:0] [--config NAME ...]
        [--decode-sizes 8192,16384,32768,65536] [--no-fixed] [--corpus DIR] [--out PATH]

The counterpart of the JAX package's ``scripts/device_kernel_attrib.py``,
``device_kernel_times.py`` and ``route_phase_times.py``. For each config of
the work ledger's port rows (``work_ledger.PORT_CONFIGS``: the zero-flag
config at 32 KB and 64 KB, the presets, configs (a)-(e), the 8 KB sweep)
it times ``hopper_encode.encode_blocks`` on one device-resident batch of
1024 blocks of ``chip_smoke.py``'s seeded text (or of the ``--corpus``
texts), and ``hopper_decode.decode_blocks`` on the native codec's stream of
such a batch at each of ``--decode-sizes``:

- the whole call: the mean device time between a CUDA event before and
  one after each of 10 calls after a warm-up, queued behind a spin kernel
  twice as long as the host takes to queue them, the calls taking in turn
  copies of the inputs that defeat L2 (``common.cold_copies``); beside it
  the mean of 10 back-to-back calls (``common.event_seconds``);
- its parts: the same calls with an event on the call's stream just before
  and just after each kernel launch as well (the kernel library is
  wrapped, the wrappers are not touched), so that each launch (match or
  sweep, emit; decode) and each span of glue around them (the knob checks,
  the lag planes' and outputs' allocation, any cast or copy) has its time;
  the sum of the parts against the whole (their ratio: the two events a
  launch cost about 3 us of device time each), and the calls the card
  had begun before the host had queued them (``host_gap_calls``; only
  there can a host gap sit inside a call, and none is the case for a
  K-slope);
- the same parts with each call started on an idle card (``paced``), where
  the glue's spans hold the host's time before each launch;
- each kernel's work-ledger bound and its share of the kernel's time.

Each call's outputs must equal the runtime's for the same batch
(``runtime.compress`` with ``raw_triage`` off, ``runtime.decompress``).
The decode's split by element is ``decode_time``'s: its five fixed 32 KB
streams (``decode_time.fixed_cases``), timed by its loop, unless
``--no-fixed``. Runs on the card only: without one it raises. Writes
``build/tooling/kernel_attrib.json`` and prints one line per config.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

import torch

from pim_compression_tpu_torch import TorchCodecConfig, native, runtime
from pim_compression_tpu_torch.ops import _build, hopper_decode, hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import common, decode_time, tooling, work_ledger

REPS = 10
SPIN_HZ = 2e9  # the spin kernel's clock cycles a second, near the 1.98 GHz boost clock
# The kernel library's launch entry points, and the part each one times.
LAUNCHERS = {"pim_match_blocks": "match", "pim_sweep_blocks": "sweep", "pim_emit_blocks": "emit",
             "pim_decode_blocks": "decode"}


class _Marked:
    """The kernel library with a CUDA event recorded on the current stream
    just before and just after each launch, appended to ``marks`` as
    (part, event)."""

    def __init__(self, lib, marks: list):
        self._lib, self._marks = lib, marks

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in LAUNCHERS:
            return fn

        def launch(*args):
            self._marks.append((LAUNCHERS[name], _event()))
            rc = fn(*args)
            self._marks.append((LAUNCHERS[name], _event()))
            return rc

        return launch


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _spans(start, marks, end) -> list[tuple[str, float]]:
    """(part, ms) of one call from its events: the glue before the first
    launch, each launch, the glue between two launches, the glue after the
    last (``marks`` holds each launch's start and end in turn)."""
    kernels = [name for name, _ in marks[::2]]
    labels = [f"glue before {kernels[0]}" if kernels else "glue"]
    for i, name in enumerate(kernels):
        labels += [name, f"glue {name} -> {kernels[i + 1]}" if i + 1 < len(kernels) else f"glue after {name}"]
    times = [start] + [ev for _, ev in marks] + [end]
    return [(label, a.elapsed_time(b)) for label, a, b in zip(labels, times, times[1:])]


def _calls(call, turn, reps: int, marked: bool, spin_s: float) -> dict:
    """Mean ms of each part over reps calls, each between a start and an end
    event; with ``marked`` also an event before and after each launch. With
    ``spin_s`` the calls queue behind a spin kernel that long; with 0 each
    starts on an idle card. ``host_gap_calls`` counts the calls whose start
    the card had reached before the host had queued all of the call: only
    in those can the host's time sit inside the call's device span."""
    marks, calls, host, gaps = [], [], [], 0
    default = _build.load()
    if marked:
        _build._lib = _Marked(default, marks)
    try:
        torch.cuda.synchronize()
        if spin_s:
            torch.cuda._sleep(int(SPIN_HZ * spin_s))
        for _ in range(reps):
            if not spin_s:
                torch.cuda.synchronize()
            args = next(turn)
            start = _event()
            t0 = time.perf_counter()
            call(*args)
            host.append(time.perf_counter() - t0)
            end = _event()
            gaps += start.query()
            calls.append((start, list(marks), end))
            marks.clear()
        torch.cuda.synchronize()
    finally:
        _build._lib = default
    parts: dict = {}
    for start, m, end in calls:
        for label, ms in _spans(start, m, end):
            parts[label] = parts.get(label, 0.0) + ms / reps
    return {"parts_ms": parts, "sum_ms": sum(parts.values()), "host_ms_per_call": 1e3 * sum(host) / reps,
            "host_gap_calls": gaps}


def attribute(call, inputs: list[tuple], reps: int = REPS) -> dict:
    """One call's device ms (``whole_ms``: between its start and end events,
    queued), its parts and glue queued and paced, their sum against the
    whole, and the mean of back-to-back calls (``back_to_back_ms``)."""
    turn = itertools.cycle(inputs)
    t0 = time.perf_counter()
    call(*next(turn))  # the warm-up, and the host's time to queue a call
    spin_s = 2 * (reps + 1) * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    whole = _calls(call, turn, reps, marked=False, spin_s=spin_s)
    parts = _calls(call, turn, reps, marked=True, spin_s=spin_s)
    return {"whole_ms": whole["sum_ms"], **parts, "sum_over_whole": parts["sum_ms"] / whole["sum_ms"],
            "whole_host_gap_calls": whole["host_gap_calls"],
            "back_to_back_ms": common.event_seconds(lambda: call(*next(turn)), reps) * 1e3,
            "paced": _calls(call, turn, reps, marked=True, spin_s=0)}


def _share(rec: dict, part: str, work: dict) -> dict:
    ms = rec["parts_ms"][part]
    return {"bound_ms": work["bound_ms"], "bound_by": work["bound_by"], "ms": ms, "share": work["bound_ms"] / ms}


def encode_config(name: str, data: bytes, dev) -> dict:
    """One compress config's attribution on a batch of ``data``."""
    bs, fields = work_ledger.PORT_CONFIGS[name]
    _, knobs = work_ledger.port_knobs(name)
    kernel = "sweep" if knobs["matcher"] == "sweep" else "match"
    blocks_np, lens_np = work_ledger.batch(data, bs, work_ledger.BATCH)
    cap = pipeline.padded_capacity(bs)
    lens = torch.from_numpy(lens_np).to(dev)
    inputs = [(b, lens) for b in common.cold_copies(torch.from_numpy(blocks_np).to(dev))]
    comp, sizes = hopper_encode.encode_blocks(*inputs[0], cap=cap, **knobs)
    cfg = TorchCodecConfig(engine="cuda", device=dev, block_size=bs, raw_triage=False, **fields)
    stream = bytes(runtime.compress(blocks_np.tobytes(), cfg))
    info = pipeline.scan_frames(stream)
    comp_h, sizes_h = comp.cpu().numpy(), sizes.cpu().numpy()
    for i, (o, s) in enumerate(zip(info["payload_off"], info["payload_size"])):
        if s != sizes_h[i] or stream[o : o + s] != comp_h[i, :s].tobytes():
            raise AssertionError(f"kernel_attrib {name}: block {i} differs from runtime.compress's")
    rec = attribute(lambda b, n: hopper_encode.encode_blocks(b, n, cap=cap, **knobs), inputs)
    match_knobs = {k: v for k, v in knobs.items() if k != "matcher"}
    match = hopper_sweep.sweep_match if kernel == "sweep" else hopper_match.match_blocks
    mlen, mlag = match(*inputs[0], **match_knobs)
    work = (work_ledger.sweep_work(*inputs[0], mlen, mlag, match_knobs) if kernel == "sweep"
            else work_ledger.match_work(mlen, match_knobs))
    rec["bounds"] = {kernel: _share(rec, kernel, work),
                     "emit": _share(rec, "emit", work_ledger.emit_work(lens_np, bs, cap))}
    return {"config": name, "direction": "compress", "bs": bs, "blocks": len(lens_np),
            "payload_bytes": int(lens_np.sum()), "knobs": {k: list(v) if isinstance(v, tuple) else v
                                                           for k, v in knobs.items()}, **rec}


def decode_config(bs: int, data: bytes, dev) -> dict:
    """The decode's attribution on the native codec's stream of a batch of ``data``."""
    blocks_np, lens_np = work_ledger.batch(data, bs, work_ledger.BATCH)
    plain = blocks_np.tobytes()
    stream = native.compress(plain, bs)
    comp, clen, olen = (torch.from_numpy(a).to(dev)
                        for a in pipeline.blockize_compressed(stream, pipeline.scan_frames(stream)))
    out, err = hopper_decode.decode_blocks(comp, clen, olen, block_size=bs)
    want = bytes(runtime.decompress(stream, TorchCodecConfig(engine="cuda", device=dev, block_size=bs)))
    if bool(err.any()) or out.cpu().numpy().tobytes() != plain or want != plain:
        raise AssertionError(f"kernel_attrib decode {bs}: the kernel's rows or the runtime's output differ")
    inputs = [(c, clen, olen) for c in common.cold_copies(comp)]
    rec = attribute(lambda c, cl, ol: hopper_decode.decode_blocks(c, cl, ol, block_size=bs), inputs)
    rec["bounds"] = {"decode": _share(rec, "decode", work_ledger.decode_work(clen, olen, bs))}
    return {"config": f"{bs} decode", "direction": "decompress", "bs": bs, "blocks": len(lens_np),
            "payload_bytes": int(lens_np.sum()), **rec}


def run(device="cuda:0", names=None, decode_sizes=work_ledger.DECODE_SIZES, fixed: bool = True, corpus=None,
        payloads: dict | None = None) -> dict:
    """The records of each decode size and compress config (every port
    config when ``names`` is None), and the fixed streams' split."""
    dev = common.cuda_device(device)
    torch.cuda.set_device(dev)
    cache = payloads if payloads is not None else {}
    names = list(work_ledger.PORT_CONFIGS) if names is None else list(names)
    common.warm(dev)
    out = {"card": common.card(dev), "reps": REPS, "records": []}
    for bs in decode_sizes:
        out["records"].append(decode_config(bs, work_ledger.payload_for(bs, corpus, cache), dev))
    for name in names:
        bs = work_ledger.PORT_CONFIGS[name][0]
        out["records"].append(encode_config(name, work_ledger.payload_for(bs, corpus, cache), dev))
    if fixed:
        out["fixed_streams"] = decode_time.time_cases(decode_time.inputs(dev, decode_time.fixed_cases()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pim_compression_tpu_torch.scripts.kernel_attrib",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0", help="the CUDA device to measure (default cuda:0)")
    ap.add_argument("--config", action="append", default=None,
                    help=f"a compress config (repeatable; default all of {list(work_ledger.PORT_CONFIGS)})")
    ap.add_argument("--decode-sizes", default=",".join(map(str, work_ledger.DECODE_SIZES)),
                    help="block sizes of the decode records, comma-separated ('' for none)")
    ap.add_argument("--no-fixed", action="store_true", help="skip the decode's fixed streams")
    tooling.add_corpus_arg(ap)
    ap.add_argument("--out", default="build/tooling/kernel_attrib.json")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.decode_sizes.split(",") if s)
    result = run(args.device, args.config, sizes, not args.no_fixed, args.corpus)
    for r in result["records"]:
        parts = ", ".join(f"{k} {v:.4f}" for k, v in r["parts_ms"].items())
        shares = ", ".join(f"{k} {b['share']:.2%} of {b['bound_ms']:.4f}" for k, b in r["bounds"].items())
        print(f"{r['config']}: whole {r['whole_ms']:.4f} ms, parts {r['sum_ms']:.4f} ({r['sum_over_whole']:.3f}): "
              f"{parts}; bound shares {shares}")
    path = tooling.output_path(args.out)
    path.write_text(json.dumps(result, indent=2, default=float) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
