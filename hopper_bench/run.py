"""Run one cell of the benchmark once and print its result line.

    python hopper_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a profiler trace of
the window. The last line of standard output is the result's JSON object;
an earlier line gives the set-up's split. The last lines of standard error
give each number compared beside its limit. Exits 2, and prints no result,
without a CUDA device or with fewer than the cell asks for.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # The port builds its kernels into build/kernels/ of the checkout, a
    # fixed path, once; it uses neither torch extensions nor Triton.
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from hopper_bench.core import cells, harness

    imported = time.perf_counter()
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    start = {"interpreter_and_imports": imported - STARTED, "device_look": time.perf_counter() - imported}
    result, code = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                    torch.device("cuda", 0), STARTED, start=start)
    if code == 0:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
