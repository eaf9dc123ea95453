"""The port's command-line interface (counterpart of ``pim_compression_tpu.cli``,
in the role of the reference CLI, ``dpu_snappy.c:93-236``).

Flag-compatible with the reference binary and with the JAX package's CLI:

    -d          use the device engine (cuda; the default already)
    -c          compress (default is decompress)
    -b <size>   decompressed block size (default 32768)
    -i <file>   input file (required)
    -o <file>   output file (default "output.txt")

``--engine {oracle,native,torch,cuda,portable}``: ``cuda`` (the
hand-written Hopper kernels) is the default, so the entry point runs on the
GPU unless asked otherwise; ``portable`` (the JAX CLI's ``xla`` engine, in
plain PyTorch ops) runs on the GPU too; ``torch`` runs the kernels' plain
PyTorch versions on the CPU, ``native`` the C++ host codec (the reference
CLI's default without ``-d``), ``oracle`` the pure-Python codec. Without a
GPU, ``cuda`` and ``portable`` exit 2 and write nothing. Every matcher flag of the JAX CLI is
taken, with its meaning; a flag passed explicitly overrides ``--preset``.
The human output keeps the reference's stdout contract (its benchmark
scripts parse "Compression ratio:" and the per-phase lines): the ratio is
``1 - compressed/original`` as ``dpu_snappy.c:212-219`` prints it. Exit
codes: 0 done, 2 a bad argument or a missing input, 1 a codec error.

    python -m pim_compression_tpu_torch -c -b 32768 -i in.txt -o out.snappy
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pathlib
import sys

# Knob flags -> TorchCodecConfig fields. They default to None, so a flag is
# set only where it was passed and a preset fills the rest.
_KNOB_FIELDS = {
    "window": "match_window", "coarse_window": "coarse_window", "coarse_mode": "coarse_mode",
    "matcher": "matcher", "prev_k": "prev_k", "stride2_min": "stride2_min", "sel_cap": "sel_cap",
    "sel_all": "sel_all", "rung_pick": "rung_pick", "sort_window": "sort_window", "ext_cap": "ext_cap",
    "neighbor": "neighbor", "max_lag": "max_lag", "sweep_span": "sweep_span",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pim-compression-tpu-torch",
        description="Block-parallel Snappy codec on PyTorch and CUDA (NVIDIA Hopper)",
    )
    flag = argparse.BooleanOptionalAction
    p.add_argument("-d", action="store_true", help="use the device engine (cuda, the default)")
    p.add_argument("-c", action="store_true", help="compress instead of decompress")
    p.add_argument("-b", type=int, default=None, metavar="SIZE", help="block size")
    p.add_argument("-i", required=True, metavar="IN", help="input file")
    p.add_argument("-o", default="output.txt", metavar="OUT", help="output file")
    p.add_argument(
        "--engine", choices=["oracle", "native", "torch", "cuda", "portable"], default=None,
        help="codec engine (default: cuda, the Hopper kernels; portable = the JAX CLI's xla "
        "engine in plain PyTorch ops on the GPU; torch = the kernels' plain PyTorch versions on "
        "the CPU; native = the C++ host codec, the reference's host default)",
    )
    p.add_argument("--threads", type=int, default=0, help="native engine threads")
    p.add_argument("--window", type=int, default=None,
                   help="sweep matcher's match window (default 512; bigger = better ratio, slower)")
    p.add_argument("--coarse-window", type=int, default=None,
                   help="sweep matcher's long-range reach beyond --window (0 = off, the default)")
    p.add_argument(
        "--coarse-mode", choices=["sampled", "granular"], default=None,
        help="long-range search: every-8th lag at byte resolution (default), or all lags at "
        "1/8 resolution (phased granules)",
    )
    p.add_argument(
        "--matcher", choices=["sorted", "sweep"], default=None,
        help="match finder: 'sorted' (default) = exact whole-block window via rung sorts "
        "(ignores --window); 'sweep' = exhaustive shifted-compare sweep bounded by --window",
    )
    p.add_argument(
        "--rungs", default=None,
        help="sorted-matcher rung ladder, e.g. 4,16,64; 'full' = 4,8,16,32,64 (default: 4,16, "
        "the rung-pick flagship)",
    )
    p.add_argument(
        "--prev-k", type=int, choices=list(range(1, 9)), default=None,
        help="sorted-matcher candidates per position on the 4-byte rung: k also tries the "
        "2nd..k-th-nearest previous occurrences (better ratio, ~one extra extension pass "
        "each; diminishing past 4; > 1 opts into the select ladder and disables --rung-pick). "
        "Default 1 (rung-pick flagship); 4 balanced; 6 ratio champion",
    )
    p.add_argument(
        "--stride2-min", type=int, choices=[0, 8, 16, 32, 64], default=None,
        help="sorted-matcher half-density threshold: rungs >= this length sort only even "
        "positions (fewer sort stages on those rungs at a small ratio cost); 0 = off (default)",
    )
    p.add_argument(
        "--sel-cap", type=int, default=None,
        help="sorted-matcher select-then-extend cap (bytes, multiple of 4 in [4,64]): prev "
        "candidates get only a cheap capped extension and the winner alone is fully extended; "
        "> 0 opts into the select ladder and disables --rung-pick; 0 = off (default; 16 = the "
        "measured knee of the select ladder)",
    )
    p.add_argument(
        "--sel-all", default=None, action=flag,
        help="sorted-matcher global select-then-extend (needs --sel-cap): every candidate "
        "array (rungs + prev ladder) gets only the capped extension, then the winner one full "
        "extension (default off)",
    )
    p.add_argument(
        "--rung-strides", default=None,
        help="sorted-matcher per-rung sort densities, e.g. 1,8 (parallel to --rungs; values "
        "1/2/4/8; overrides --stride2-min)",
    )
    p.add_argument(
        "--rung-pick", default=None, action=flag,
        help="rung-priority selection (default on): the longest rung with a candidate wins and "
        "one extension verifies it. Auto-disabled when --prev-k > 1 or --sel-cap > 0 (those "
        "opt into the select ladder); --no-rung-pick runs the per-rung ladder",
    )
    p.add_argument(
        "--sort-window", type=int, default=None,
        help="sorted-matcher candidate window (bytes, power of two >= 512 dividing the block "
        "size padded to a power of two; 0 = whole block, the default): chunk-local rung sorts, "
        "fewer sort stages and a bounded reach for some ratio",
    )
    p.add_argument(
        "--ext-cap", type=int, default=None,
        help="sorted-matcher full-extension cap (bytes, multiple of 4 in [max(--sel-cap, 4), "
        "64]): longer matches emit as chained copies of at most this length (default 48)",
    )
    p.add_argument(
        "--neighbor", default=None, action=flag,
        help="fold each position's left-neighbor match one byte shorter after the rung/prev "
        "ladder (default on)",
    )
    p.add_argument(
        "--max-lag", type=int, default=None,
        help="sorted-matcher candidate reach cap (bytes; 0 = whole block). Default -1 = auto "
        "(8192 up to 32K blocks; full reach above)",
    )
    p.add_argument(
        "--sweep-span", type=int, choices=[2, 4, 8, 16, 32], default=None,
        help="the reference's extension-sweep span (checked; the port's kernels have no "
        "chunk sweeps, so it changes nothing here)",
    )
    p.add_argument(
        "--preset", choices=["speed", "balanced", "ratio"], default=None,
        help="measured operating point for the chosen block size (the reference's per-file "
        "best-config table, host_speedup.py:13-21): sets the matcher knobs; explicitly passed "
        "knob flags override the preset",
    )
    p.add_argument(
        "--verify", action="store_true",
        help="decode every encoded batch again on the device and compare it with its input "
        "before assembly (the reference harness's cmp check)",
    )
    p.add_argument(
        "--debug-block", type=int, default=None, metavar="N",
        help="diagnostic mode: compute block N's phases by the plain PyTorch versions and by "
        "the CUDA kernels on the GPU (needs --engine cuda), print each phase's first mismatch, "
        "write pim_debug_block.npz (PIM_DEBUG_OUT) and exit; PIM_DEBUG_BLOCK works too",
    )
    p.add_argument(
        "--no-triage", action="store_true",
        help="disable the incompressible fast path (host triage that diverts near-random "
        "blocks to raw literal frames with no device work)",
    )
    p.add_argument(
        "--strict-engine", action="store_true",
        help="compress: fail (exit 2) where the cuda or torch engine would fall back to the "
        "portable engine (a block size outside [256, 65536] or not a multiple of 128, the sweep "
        "matcher above 16384), instead of warning and falling back; decompress never falls back",
    )
    p.add_argument(
        "--pipeline-depth", type=int, default=2,
        help="device batches in flight (each on a CUDA stream with pinned host buffers); "
        "<= 1 runs them synchronously, with exact per-phase times",
    )
    p.add_argument("--json", action="store_true", help="emit structured metrics")
    p.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a torch.profiler trace of the codec run (with CUDA activity on the cuda and "
        "portable engines) to DIR/trace.json; the cuda engine's kernels add their own spans, each "
        "launch from its first walk's start to its last walk's end, on a track of their own",
    )
    return p


def _ints(text: str) -> tuple[int, ...]:
    return tuple(int(v) for v in text.split(","))


def _config(args, block_size: int, engine: str):
    """The TorchCodecConfig of the parsed flags: explicit flags, then the
    preset's row for the block size, then the config's defaults."""
    from pim_compression_tpu_torch.utils.config import TorchCodecConfig, preset_overrides

    knobs = preset_overrides(args.preset, block_size) if args.preset else {}
    knobs.update({field: getattr(args, dest) for dest, field in _KNOB_FIELDS.items() if getattr(args, dest) is not None})
    if args.rungs is not None:
        knobs["rungs"] = None if args.rungs in ("", "full") else _ints(args.rungs)
    if args.rung_strides is not None:
        knobs["rung_strides"] = _ints(args.rung_strides)
    # As in the JAX CLI, sel_all takes effect only with a sel_cap (default 0).
    knobs["sel_all"] = bool(knobs.get("sel_all")) and knobs.get("sel_cap", 0) > 0
    return TorchCodecConfig(
        block_size=block_size, engine=engine, num_threads=args.threads, raw_triage=not args.no_triage,
        verify=args.verify, pipeline_depth=args.pipeline_depth, strict_engine=args.strict_engine, **knobs,
    )


def _debug(dbg: int, args, config, data: bytes) -> int:
    from pim_compression_tpu_torch.utils import debug

    if args.c:
        block = data[dbg * config.block_size : (dbg + 1) * config.block_size]
        if dbg < 0 or not block:
            print(f"error: block {dbg} out of range", file=sys.stderr)
            return 2
        mismatches = debug.debug_encode_block(block, config)
    else:
        frame = debug.stream_block(data, dbg)
        if frame is None:
            print(f"error: block {dbg} out of range", file=sys.stderr)
            return 2
        mismatches = debug.debug_decode_block(*frame, config)
    return 1 if mismatches else 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from pim_compression_tpu_torch import runtime
    from pim_compression_tpu_torch.format import constants as C
    from pim_compression_tpu_torch.runtime import profiling
    from pim_compression_tpu_torch.format.varint import decode_varint32
    from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

    engine = args.engine or "cuda"
    block_size = args.b or C.DEFAULT_BLOCK_SIZE
    try:
        config = _config(args, block_size, engine)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    in_path = pathlib.Path(args.i)
    if not in_path.is_file():
        print(f"error: input file not found: {in_path}", file=sys.stderr)
        return 2
    data = in_path.read_bytes()

    dbg = args.debug_block
    if dbg is None and os.environ.get("PIM_DEBUG_BLOCK"):
        dbg = int(os.environ["PIM_DEBUG_BLOCK"])
    timer = runtime.PhaseTimer()
    try:
        if dbg is not None:
            return _debug(dbg, args, config, data)
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(_profiler(engine)) if args.profile else None
            if args.c:
                result = runtime.compress(data, config, timer)
                original, compressed = len(data), len(result)
            else:
                result = runtime.decompress(data, config, timer)
                original, compressed = len(result), len(data)
                _, pos = decode_varint32(data, 0)  # report the stream's own block size
                block_size, _ = decode_varint32(data, pos)
            if prof is not None:
                profiling.kernel_summary()  # read while the session records: a second clock probe in the trace
    except SnappyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2 if e.status == SnappyStatus.BAD_ARGUMENT else 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if prof is not None:
        out = pathlib.Path(args.profile)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        profiling.add_kernel_spans(out / "trace.json")
        print(f"profiler trace written to {out}")

    pathlib.Path(args.o).write_bytes(result)

    mode = "compression" if args.c else "decompression"
    print(f"Using {engine} engine for {mode} (block size {block_size})")
    if original:
        # Ratio formula per the reference CLI (dpu_snappy.c:212-219).
        print(f"Compression ratio: {1.0 - compressed / original:.6f}")
    print(timer.human())
    if args.json:
        print(timer.json(
            engine=engine, mode=mode, block_size=block_size, original_bytes=original,
            compressed_bytes=compressed,
        ))
    return 0


def _profiler(engine: str):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if engine in ("cuda", "portable") and torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


if __name__ == "__main__":
    sys.exit(main())
