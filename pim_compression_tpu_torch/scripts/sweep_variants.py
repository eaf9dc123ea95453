"""Build csrc/sweep.cu with some of its integer constants replaced, and time each build.

    python3 -m pim_compression_tpu_torch.scripts.sweep_variants [--device cuda:0]

Each variant in VARIANTS names the ``constexpr int`` constants of
``csrc/sweep.cu`` it replaces (the entries a lane walks before its warp
takes the rest ``kBudget``, a budget past any chain being the build without
the handoff; the CTA's threads ``kThreads`` and the CTAs an SM the
registers must allow ``kMinCtas``). It is compiled with
``ops/_build.py``'s nvcc flags into ``build/sweep_variants/<name>/``, its
ptxas report for the sweep kernel (registers, stack frame, spills) is kept
(both by ``match_variants.build_variants``), and it runs ``sweep_time``'s
cases in place of the default build: each record says whether its lengths
and lags equal the default build's, and its time is taken the same way.
The default (the source as it is) is built the same way and timed first
and last, so the spread of one build's time shows beside the variants'.
Writes ``build/probes/sweep_variants.json`` and prints one JSON line.
"""

from __future__ import annotations

import json

from pim_compression_tpu_torch.ops import _build
from pim_compression_tpu_torch.scripts import common, sweep_time
from pim_compression_tpu_torch.scripts.match_variants import build_variants

# name -> {constant: value}. kThreads is 256, 512 or 1024 (the digit counts
# are one pair a thread: 64 bins x kThreads / 32 warps = 2 kThreads);
# kMinCtas sets the registers a thread may take (65536 / (kMinCtas kThreads)).
VARIANTS = {
    "budget-4": {"kBudget": 4},
    "budget-16": {"kBudget": 16},
    "no-handoff": {"kBudget": 1 << 20},
    "512-threads": {"kThreads": 512},
    "18-bit-keys": {"kPasses": 3},
}


def run(device) -> list[dict]:
    import torch

    dev = common.cuda_device(device)
    torch.cuda.set_device(dev)
    default = _build.load()
    builds = build_variants({"default": {}, **VARIANTS}, "sweep.cu")
    todo = sweep_time.inputs(dev, sweep_time.cases())
    common.warm(dev)
    out, want = [{"card": common.card(dev)}], None
    try:
        for name in ["default", *VARIANTS, "default"]:
            handle, ptxas = builds[name]
            _build._lib = handle  # hopper_sweep.sweep_match launches through _build.load()
            records, outputs = sweep_time.time_cases(todo, check=want)
            want = want or outputs
            ctas = {bs: sweep_time.ctas_per_sm(handle, bs, dev) for bs in (8192, 16384)}
            out.append({"variant": name, "consts": VARIANTS.get(name, {}), "ptxas": ptxas, "ctas_per_sm": ctas,
                        "cases": records})
    finally:
        _build._lib = default
    return out


def main(argv=None) -> int:
    rc = common.main("sweep_variants", run, __doc__.splitlines()[0], argv)
    print(json.dumps(json.loads((common.OUT_DIR / "sweep_variants.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
