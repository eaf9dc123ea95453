"""Build csrc/decode.cu with some of its integer constants replaced, and time each build.

    python3 -m pim_compression_tpu_torch.scripts.decode_variants [--device cuda:0]

Each variant in VARIANTS names the ``constexpr int`` constants of
``csrc/decode.cu`` it replaces (the warps of a CTA ``kWarps``, the history
ring ``kRing`` and its flush ``kChunk``, the window's halves ``kHalf``). It
is compiled with ``ops/_build.py``'s nvcc flags into
``build/decode_variants/<name>/``, its ptxas report for the decode kernel
(registers, stack frame, spills) is kept (both by
``match_variants.build_variants``), and it runs ``decode_time``'s cases in
place of the default build: each record says whether its output rows and
error words equal the default build's, and its time is taken the same way.
The default (the source as it is) is built the same way and timed first and
last, so the spread of one build's time shows beside the variants'. Writes
``build/probes/decode_variants.json`` and prints one JSON line.
"""

from __future__ import annotations

import json

from pim_compression_tpu_torch.ops import _build
from pim_compression_tpu_torch.scripts import common, decode_time
from pim_compression_tpu_torch.scripts.match_variants import build_variants

# name -> {constant: value}. kRing is a power of two, kChunk divides it and
# is at most kRing - 64; kHalf is a power of two of at least 512.
VARIANTS = {
    "ring-8192": {"kRing": 8192, "kChunk": 2048},
    "ring-32768": {"kRing": 32768, "kChunk": 8192},
    "1-warp-per-cta": {"kWarps": 1},
    "2-warps-per-cta": {"kWarps": 2},
}


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    todo = decode_time.inputs(dev, decode_time.cases())
    default = _build.load()
    builds = build_variants({"default": {}, **VARIANTS}, "decode.cu")
    common.warm(dev)
    out, want = [{"card": common.card(dev)}], None
    try:
        for name in ["default", *VARIANTS, "default"]:
            handle, ptxas = builds[name]
            _build._lib = handle  # hopper_decode.decode_blocks launches through _build.load()
            records = decode_time.time_cases(todo)
            for rec, ref in zip(records, want or records):
                rec["equal"] = rec["digest"] == ref["digest"]
            want = want or records
            out.append({"variant": name, "consts": VARIANTS.get(name, {}), "ptxas": ptxas, "cases": records})
    finally:
        _build._lib = default
    return out


def main(argv=None) -> int:
    rc = common.main("decode_variants", run, __doc__.splitlines()[0], argv)
    print(json.dumps(json.loads((common.OUT_DIR / "decode_variants.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
