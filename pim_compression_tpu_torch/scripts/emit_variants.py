"""Build csrc/emit.cu with some of its integer constants replaced, and time each build.

    python3 -m pim_compression_tpu_torch.scripts.emit_variants [--device cuda:0]

Each variant in VARIANTS names the ``constexpr int`` constants of
``csrc/emit.cu`` it replaces (the warps of a CTA ``kWarps``, the positions
a warp stages ``kWindow``). It is compiled with ``ops/_build.py``'s nvcc
flags into ``build/emit_variants/<name>/``, its ptxas report for the emit
kernel (registers, stack frame, spills, shared memory) is kept (both by
``match_variants.build_variants``), and it runs
``emit_time``'s cases in place of the default build: each record says
whether its sizes and bytes equal the default build's on every block, and
its time is taken the same way. The default (the source as it is) is built
the same way and timed first and last, so the spread of one build's time
shows beside the variants'. Writes ``build/probes/emit_variants.json`` and
prints one JSON line.
"""

from __future__ import annotations

import json

from pim_compression_tpu_torch.ops import _build
from pim_compression_tpu_torch.scripts import common, emit_time
from pim_compression_tpu_torch.scripts.match_variants import build_variants

# name -> {constant: value}. kWindow is a multiple of 512; kWarps * (4 * kWindow + 2048) bytes stay under 48 KB.
VARIANTS = {
    "window-2048": {"kWindow": 2048},
    "1-warp-per-cta": {"kWarps": 1},
}


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    todo = emit_time.inputs(dev, emit_time.cases())
    default = _build.load()
    builds = build_variants({"default": {}, **VARIANTS}, "emit.cu")
    common.warm(dev)
    out, want = [{"card": common.card(dev)}], None
    try:
        for name in ["default", *VARIANTS, "default"]:
            handle, ptxas = builds[name]
            _build._lib = handle  # hopper_encode.emit_blocks launches through _build.load()
            records, outputs = emit_time.time_cases(todo, check=want)
            want = want or outputs
            out.append({"variant": name, "consts": VARIANTS.get(name, {}), "ptxas": ptxas, "cases": records})
    finally:
        _build._lib = default
    return out


def main(argv=None) -> int:
    rc = common.main("emit_variants", run, __doc__.splitlines()[0], argv)
    print(json.dumps(json.loads((common.OUT_DIR / "emit_variants.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
