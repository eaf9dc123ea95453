"""The work ledger: what each kernel's function must do, and the least time the card could take for it.

    python -m pim_compression_tpu_torch.scripts.work_ledger [--device cuda:0] [--blocks N]
        [--rows all|port|reference] [--config NAME ...] [--corpus DIR] [--out PATH]

The counterpart of the JAX package's ``scripts/op_ledger.py``, and the one
place where the port counts the work of its kernels' functions: the
bounds of ``chip_smoke.py``'s kernels line, of ``kernel_attrib`` and of
``pipeline_times`` all come from the functions here. A count reads only a
kernel's inputs and its function's outputs, never a kernel's internal
state, so every implementation of a function is held to the same count:

- bytes: each input read once and each output written once;
- operations: the integer operations these inputs need: for the decode one
  a plaintext byte; for the sorted matcher one table step per sorted row
  (``ceil(bs / stride)`` of a rung) and candidate (``prev_k`` on the 4-byte
  rung in the ladder modes) plus one word compare per 4 bytes of each
  output length; for the sweep one table step per position plus the
  (position, lag) pairs whose first words match, with the pairs an
  exhaustive sweep visits beside; for the emit one parse step a position;
  for a probe the steps its inputs take;
- the bound: the larger of the bytes over the card's memory rate and the
  operations over its int32 issue rate (``bound``).

The ledger's rows, each on one batch of ``--blocks`` blocks (1024) of
``chip_smoke.py``'s seeded text (or of the ``--corpus`` texts): the decode
at bs 8192, 16384, 32768 and 65536 (the native codec's stream of the
batch); the port's main-path configs (``PORT_CONFIGS``: the zero-flag
config at 32 KB and at 64 KB, where it runs the ``sel_all`` ladder, the
presets' rows at both sizes, ``chip_smoke.py``'s sort-mode configs
(a)-(e) and the 8 KB sweep); and
every config of ``op_ledger.py:391-456`` (``REFERENCE_CONFIGS``, read with
the defaults of the JAX package's ``encode_blocks_pallas``). Each row gives
the bytes and operations, the bound and what bounds it, both per payload
byte, and the ceiling in GB/s (payload bytes over the bound). The matcher's
lengths come from the kernels on the card, or from their plain versions
with ``--device cpu``: both are exact, so both give the same count.
Writes ``build/tooling/work_ledger.json`` (relative to the working
directory) and prints one line per row.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pim_compression_tpu_torch import TorchCodecConfig, native
from pim_compression_tpu_torch.format import oracle
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match, hopper_probes, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.scripts import common, tooling, transfer_probe
from pim_compression_tpu_torch.utils import streams
from pim_compression_tpu_torch.utils.config import preset_overrides

# The card's rates for the bounds (H100 SXM): device memory 3.35 TB/s (the
# datasheet), and int32 operations at the issue limit, one warp instruction
# per scheduler per clock (4 x 32 = 128 lanes per SM) on 132 SMs at the 1.98
# GHz boost clock. The 64 INT32 lanes per SM alone (16.73e12 ops/s) are no
# bound: integer multiplies issue to the FMA pipe beside them, and the
# probes' mix rounds and elementwise chain run above that rate. The codec's
# kernels are integer-only; no tensor-core rate applies.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_S = 132 * 64 * 1.98e9
INT32_OPS_PER_S = 132 * 128 * 1.98e9

SEED = 20261016  # chip_smoke.py's payloads
BLOCKS = 1100  # their length in blocks, less 1000 bytes
BATCH = 1024
DECODE_SIZES = (8192, 16384, 32768, 65536)
# The sweep's main config: README's best bs-8192 point.
SWEEP_MAIN = dict(matcher="sweep", match_window=2048, coarse_window=8192, coarse_mode="granular")
# The port's main-path configs, as TorchCodecConfig fields: the zero-flag
# config at 32 KB and at 64 KB (the runtime's sel_all ladder there), the
# presets' rows at both sizes (at 64 KB "ratio" is "balanced"),
# chip_smoke.py's SORT_MODES (a)-(e), and the 8 KB sweep.
PORT_CONFIGS = {
    "32768 zero-flag": (32768, {}),
    "65536 zero-flag": (65536, {}),
    **{f"{bs} {preset}": (bs, preset_overrides(preset, bs)) for bs in (32768, 65536)
       for preset in ("speed", "balanced", "ratio") if (bs, preset) != (65536, "ratio")},
    "config (a)": (32768, dict(rungs=None, prev_k=4, sel_cap=16, stride2_min=16)),
    "config (b)": (32768, dict(rungs=(4, 16), rung_pick=False, prev_k=6)),
    "config (c)": (32768, dict(rungs=(4, 16), sort_window=8192)),
    "config (d)": (32768, dict(rungs=(4, 32), prev_k=2, sel_cap=16, sel_all=True, rung_strides=(1, 8))),
    "config (e)": (65536, dict(rungs=(4, 32), rung_strides=(1, 2), sort_window=16384)),
    "8192 sweep": (8192, SWEEP_MAIN),
}
# op_ledger.py:391-456: the JAX package's ledger configs, as
# encode_blocks_pallas keyword arguments.
REFERENCE_CONFIGS = [
    dict(block_size=32768, matcher="sorted", rungs=(4, 16), prev_k=1, ext_cap=48, neighbor=True, rung_pick=True),
    dict(block_size=16384, matcher="sorted", rungs=(4, 16), prev_k=1, ext_cap=48, neighbor=True, rung_pick=True),
    dict(block_size=32768, matcher="sorted", rungs=(4,), prev_k=2, sel_cap=16, sel_all=True, ext_cap=48,
         neighbor=True),
    dict(block_size=32768, matcher="sorted", rungs=(4,), prev_k=2, sel_cap=16, sel_all=True),
    dict(block_size=32768, matcher="sorted", rungs=(4,), prev_k=2, sel_cap=8, sel_all=True),
    dict(block_size=32768, matcher="sorted", rungs=(4,), prev_k=4, sel_cap=16, sel_all=True),
    dict(block_size=32768, matcher="sorted", rungs=(4,), prev_k=6, sel_cap=16, sel_all=True),
    dict(block_size=16384, matcher="sorted", rungs=(4,), prev_k=3, sel_cap=16, sel_all=True),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=2, stride2_min=32, sel_cap=16, sel_all=True),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=2, rung_strides=(1, 8), sel_cap=16,
         sel_all=True),
    dict(block_size=16384, matcher="sorted", rungs=(4, 32), prev_k=2, stride2_min=32, sel_cap=16, sel_all=True),
    dict(block_size=8192, matcher="sorted"),
    dict(block_size=16384, matcher="sorted"),
    dict(block_size=32768, matcher="sorted"),
    dict(block_size=32768, matcher="sorted", rungs=(4, 16, 64)),
    dict(block_size=16384, matcher="sorted", rungs=(4, 16, 64)),
    dict(block_size=32768, matcher="sorted", prev_k=2),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=2, stride2_min=32),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=2),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=4),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=4, sel_cap=16),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=6, sel_cap=16),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=6),
    dict(block_size=32768, matcher="sorted", rungs=(4, 32), prev_k=8),
    dict(block_size=16384, matcher="sorted", rungs=(4, 32), prev_k=2),
    dict(block_size=16384, matcher="sorted", rungs=(4, 32), prev_k=4),
    dict(block_size=32768, matcher="sorted", rungs=(4, 16, 64), prev_k=2, stride2_min=16),
    dict(block_size=16384, matcher="sorted", rungs=(4, 16, 64), prev_k=2, stride2_min=16),
    dict(block_size=8192, matcher="sweep", window=512, coarse_window=4096, granular=True),
    dict(block_size=8192, matcher="sweep", window=2048, coarse_window=8192, granular=True),
]
# The reference kernels' defaults for the keys a reference config may leave
# out (encode_blocks_pallas, lane_model_encode.match_search_sorted).
REFERENCE_DEFAULTS = dict(
    matcher="sorted", rungs=(4, 8, 16, 32, 64), prev_k=1, stride2_min=0, sel_cap=0, sel_all=False,
    rung_strides=None, ext_cap=64, neighbor=False, sort_window=0, rung_pick=False, max_lag=0,
    window=512, coarse_window=0, granular=False, sweep_span=4,
)


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes the function must move (each input read once, each output written
    once) over the memory rate and its integer operations over the int32
    issue limit."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "ops": ops,
    }


def decode_work(comp_len, out_len, block_size: int) -> dict:
    """The decode of a batch: each payload byte and both lengths read, every
    output row (``block_size`` bytes) and verdict (4 bytes) written; one
    operation per plaintext byte."""
    nb = len(comp_len)
    return bound(int(comp_len.sum()) + 8 * nb + nb * block_size + 4 * nb, int(out_len.sum()))


def _match_bytes(nb: int, bs: int) -> int:
    """Blocks and lengths read, one byte of length and two of lag written a position."""
    return 4 * nb * bs + 4 * nb


def match_work(mlen, knobs: dict) -> dict:
    """The sorted matcher on a batch, from its output lengths ``mlen``
    (uint8[nb, bs]) and ``knobs`` (``hopper_encode.encode_knobs``): one table
    step per sorted row of each rung and candidate, one word compare per 4
    bytes of each length."""
    nb, bs = mlen.shape
    rungs = knobs.get("rungs", (4, 16))
    strides = knobs.get("strides") or (1,) * len(rungs)
    ladder = knobs.get("sel_all") or not knobs.get("rung_pick", True)
    steps = sum(-(-bs // s) * (knobs.get("prev_k", 1) if r == 4 and ladder else 1) for r, s in zip(rungs, strides))
    return bound(_match_bytes(nb, bs), nb * steps + int(((mlen.long() + 3) >> 2).sum()))


def sweep_work(blocks, lens, mlen, mlag, knobs: dict) -> dict:
    """The sweep matcher on a batch, from its inputs and its output: one
    table step per position plus the pairs whose first words match
    (``hopper_sweep.sweep_pairs``); the pairs an exhaustive sweep visits and
    their bound beside."""
    nb, bs = mlen.shape
    visited, first_word = hopper_sweep.sweep_pairs(
        blocks, lens, mlen, mlag, knobs["window"], knobs["coarse_window"], knobs["granular"])
    work = bound(_match_bytes(nb, bs), nb * bs + first_word)
    work.update(visited_pairs=visited, first_word_pairs=first_word,
                visited_bound=bound(_match_bytes(nb, bs), visited))
    return work


def emit_work(lens, block_size: int, cap: int) -> dict:
    """The emit of a batch: blocks, lengths (1 byte) and lags (2) read, each
    padded row of ``cap`` bytes written, both size vectors; one parse step
    a plaintext byte."""
    nb = len(lens)
    return bound(nb * (4 * block_size + cap) + 8 * nb, int(lens.sum()))


def probe_work(name: str, rows: int, steps: int = 0, out_rows: int = 0) -> dict:
    """A probe kernel of ``csrc/probes.cu`` on int32 (rows, 128) planes:
    the steps its inputs take. The chains read and write their plane (and
    an index plane beside for the gather) and do two operations a lane and
    step; the copy moves ``transfer_probe.copy_bytes``; the mix rounds and
    the chain fold do three a lane and round and one more to fold (the
    chain fold's input is one row, its lanes ``rows`` x 128)."""
    lanes = rows * hopper_probes.LANES
    tail = 8 * hopper_probes.LANES * 4  # the 8-row result a chain or fold writes
    if name in ("gather_chain", "ew_chain"):
        return bound(2 * lanes * 4 + tail, 2 * lanes * steps)
    if name == "copy_rows":
        return bound(transfer_probe.copy_bytes(rows, out_rows), 0)
    if name == "mix_rounds":
        return bound(lanes * 4 + tail, 3 * steps * lanes + lanes)
    if name == "chain_fold":
        return bound(hopper_probes.LANES * 4 + tail, 3 * steps * lanes + lanes)
    raise ValueError(f"no probe {name!r}")


def reference_knobs(cfg: dict) -> dict:
    """A reference kernel's keyword arguments (``encode_blocks_pallas``, or
    ``lane_model_encode.match_search_sorted`` for the sorted matcher), with
    its defaults for the keys left out, as the port's matcher knobs (with
    ``matcher``), checked as the port's matchers check them. Unlike
    ``hopper_encode.encode_knobs`` it keeps a 64 KB config as given, as the
    reference kernels do: the runtime's switch to the ``sel_all`` ladder
    above 32 KB is the runtime's. Raises ``ValueError`` for a knob the port
    does not have or refuses."""
    extra = set(cfg) - set(REFERENCE_DEFAULTS) - {"block_size"}
    if extra:
        raise ValueError(f"the port's matchers have no {sorted(extra)}")
    c = dict(REFERENCE_DEFAULTS, **cfg)
    bs = cfg["block_size"]
    if c["matcher"] == "sweep":
        return dict(matcher="sweep", **hopper_sweep.sweep_knobs(bs, c["window"], c["coarse_window"], c["granular"]))
    rungs = tuple(c["rungs"])
    strides = tuple(c["rung_strides"] or (2 if c["stride2_min"] and r >= c["stride2_min"] else 1 for r in rungs))
    knobs = dict(rungs=rungs, ext_cap=c["ext_cap"], neighbor=bool(c["neighbor"]), max_lag=c["max_lag"],
                 prev_k=c["prev_k"], sel_cap=c["sel_cap"], sel_all=bool(c["sel_all"]),
                 rung_pick=bool(c["rung_pick"]), strides=strides, sort_window=c["sort_window"])
    hopper_match.check_knobs(bs, **{k: v for k, v in knobs.items() if k != "neighbor"})
    return dict(matcher="sorted", **knobs)


def reference_label(cfg: dict) -> str:
    """op_ledger.py's row label of a reference config."""
    c = dict(REFERENCE_DEFAULTS, **cfg)
    parts = [f"encode bs={cfg['block_size']} {c['matcher']}"]
    if c["matcher"] == "sweep":
        return " ".join(parts + [f"w={c['window']} c={c['coarse_window']}"] + (["granular"] if c["granular"] else []))
    if "rungs" in cfg:
        parts.append("rungs=" + ",".join(map(str, c["rungs"])))
    parts += [f"prev{c['prev_k']}"] if c["prev_k"] > 1 else []
    parts += [f"s2@{c['stride2_min']}"] if c["stride2_min"] else []
    parts += [f"sel{c['sel_cap']}"] if c["sel_cap"] else []
    parts += ["selall"] if c["sel_all"] else []
    parts += [f"ext{c['ext_cap']}"] if c["ext_cap"] != 64 else []
    parts += ["nb"] if c["neighbor"] else []
    parts += ["rs=" + ",".join(map(str, c["rung_strides"]))] if c["rung_strides"] else []
    parts += ["pick"] if c["rung_pick"] else []
    return " ".join(parts)


def port_knobs(name: str) -> tuple[int, dict]:
    """(block size, matcher knobs with ``matcher``) of a ``PORT_CONFIGS``
    config, as the runtime runs it (``hopper_encode.encode_knobs``)."""
    bs, fields = PORT_CONFIGS[name]
    return bs, {"matcher": "sorted", **hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs, **fields))}


def configs(rows: str = "all") -> dict[str, tuple[int, dict]]:
    """name -> (block size, matcher knobs) of each encode row: ``port``,
    ``reference`` or ``all``."""
    out = {}
    if rows in ("all", "port"):
        out.update({name: port_knobs(name) for name in PORT_CONFIGS})
    if rows in ("all", "reference"):
        out.update({reference_label(cfg): (cfg["block_size"], reference_knobs(cfg)) for cfg in REFERENCE_CONFIGS})
    return out


def payload_for(block_size: int, corpus=None, cache: dict | None = None) -> bytes:
    """chip_smoke.py's payload for a block size: ``BLOCKS`` blocks of 32 KB
    (cut for smaller blocks) or of 64 KB, less 1000 bytes, of seeded text,
    or the ``corpus`` directory's texts cycled to that length."""
    size = 32768 if block_size <= 32768 else 65536
    cache = {} if cache is None else cache
    if size not in cache:
        n = BLOCKS * size - 1000
        texts = tooling.seed_text(corpus) if corpus else None
        cache[size] = tooling.cycled(texts, n) if texts else streams.text_payload(n, SEED)
    return cache[size]


def batch(data: bytes, block_size: int, blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``blocks`` whole blocks of ``data``: (uint8[n, bs], int32[n])."""
    n = min(blocks, len(data) // block_size)
    return (np.frombuffer(data[: n * block_size], np.uint8).reshape(n, block_size).copy(),
            np.full(n, block_size, np.int32))


def _row(kernel: str, config: str, bs: int, nb: int, payload: int, work: dict, **extra) -> dict:
    return {
        "kernel": kernel, "config": config, "bs": bs, "blocks": nb, "payload_bytes": payload,
        "bytes": work["bytes"], "ops": work["ops"], "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
        "bytes_per_payload_byte": work["bytes"] / payload, "ops_per_payload_byte": work["ops"] / payload,
        "ceiling_gbps": payload / work["bound_ms"] / 1e6, **extra,
    }


def decode_row(data: bytes, block_size: int, blocks: int) -> dict:
    """The decode row of a batch: the native codec's stream of its blocks."""
    plain = data[: min(blocks, len(data) // block_size) * block_size]
    stream = native.compress(plain, block_size) if native.available() else oracle.compress(plain, block_size)
    _, comp_len, out_len = pipeline.blockize_compressed(stream, pipeline.scan_frames(stream))
    work = decode_work(comp_len, out_len, block_size)
    return _row("decode", f"{block_size} decode", block_size, len(out_len), int(out_len.sum()), work)


def encode_rows(name: str, knobs: dict, blocks_np, lens_np, device) -> list[dict]:
    """The match (or sweep) and emit rows of one config (its matcher knobs,
    with ``matcher``) on a batch, the matcher's output from
    ``match_blocks`` / ``sweep_match`` on ``device``."""
    knobs = dict(knobs)
    sweep = knobs.pop("matcher") == "sweep"
    blocks, lens = torch.from_numpy(blocks_np).to(device), torch.from_numpy(lens_np).to(device)
    nb, bs = blocks.shape
    payload = int(lens_np.sum())
    shown = {k: list(v) if isinstance(v, tuple) else v for k, v in knobs.items()}
    if sweep:
        mlen, mlag = hopper_sweep.sweep_match(blocks, lens, **knobs)
        work = sweep_work(blocks, lens, mlen, mlag, knobs)
        extra = {"visited_pairs": work["visited_pairs"], "first_word_pairs": work["first_word_pairs"],
                 "visited_bound_ms": work["visited_bound"]["bound_ms"]}
        match_row = _row("sweep", name, bs, nb, payload, work, knobs=shown, **extra)
    else:
        mlen, _ = hopper_match.match_blocks(blocks, lens, **knobs)
        match_row = _row("match", name, bs, nb, payload, match_work(mlen, knobs), knobs=shown)
    emit = emit_work(lens_np, bs, pipeline.padded_capacity(bs))
    return [match_row, _row("emit", name, bs, nb, payload, emit)]


def resolve(device) -> torch.device:
    """The device to count on: a CUDA device (raises without one), or the CPU when named."""
    dev = torch.device(device)
    return dev if dev.type == "cpu" else common.cuda_device(dev)


def run(device="cuda:0", blocks: int = BATCH, rows: str = "all", names=None, corpus=None,
        payloads: dict | None = None, decode_sizes=DECODE_SIZES) -> dict:
    """The ledger: the decode rows at ``decode_sizes`` and the match and
    emit rows of each config of ``rows`` (only ``names`` when given), on
    ``blocks``-block batches. ``payloads`` maps 32768 and 65536 to the
    payloads to cut (``payload_for``'s, made when absent)."""
    dev = resolve(device)
    cache = payloads if payloads is not None else {}
    todo = configs(rows)
    if names:
        missing = set(names) - set(todo)
        if missing:
            raise ValueError(f"no ledger config {sorted(missing)}; the configs: {sorted(todo)}")
        todo = {n: todo[n] for n in names}
    out = [decode_row(payload_for(bs, corpus, cache), bs, blocks) for bs in decode_sizes]
    for name, (bs, knobs) in todo.items():
        blocks_np, lens_np = batch(payload_for(bs, corpus, cache), bs, blocks)
        out += encode_rows(name, knobs, blocks_np, lens_np, dev)
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": common.card(dev) if dev.type == "cuda" else None,
        "rates": {"hbm_bytes_per_s": HBM_BYTES_PER_S, "int32_ops_per_s": INT32_OPS_PER_S},
        "rows": out,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pim_compression_tpu_torch.scripts.work_ledger",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0", help="where the matchers run (default cuda:0; cpu: plain versions)")
    ap.add_argument("--blocks", type=int, default=BATCH, help=f"blocks per batch (default {BATCH})")
    ap.add_argument("--rows", choices=["all", "port", "reference"], default="all")
    ap.add_argument("--config", action="append", default=None, help="only this encode config (repeatable)")
    ap.add_argument("--decode-sizes", default=",".join(map(str, DECODE_SIZES)),
                    help="block sizes of the decode rows, comma-separated ('' for none)")
    tooling.add_corpus_arg(ap)
    ap.add_argument("--out", default="build/tooling/work_ledger.json")
    args = ap.parse_args(argv)
    sizes = tuple(int(s) for s in args.decode_sizes.split(",") if s)
    ledger = run(args.device, args.blocks, args.rows, args.config, args.corpus, decode_sizes=sizes)
    for r in ledger["rows"]:
        print(f"{r['kernel']:<7}{r['config']:<62}{r['bound_ms']:>10.6f} ms ({r['bound_by']}), "
              f"{r['bytes_per_payload_byte']:.3f} B/B, {r['ops_per_payload_byte']:.3f} ops/B, "
              f"ceiling {r['ceiling_gbps']:.1f} GB/s")
    path = tooling.output_path(args.out)
    path.write_text(json.dumps(ledger, indent=2) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
