"""Build csrc/match.cu with some of its integer constants replaced, and time each build.

    python3 -m pim_compression_tpu_torch.scripts.match_variants [--device cuda:0]

Each variant in VARIANTS names the ``constexpr int`` constants of
``csrc/match.cu`` it replaces (the CTA's threads ``kMaxThreads``, the sort
words a thread holds in registers ``kHeld``, the radix passes ``kPasses``:
0 leaves the words unsorted, a wrong output whose time is the kernel's
without its sort). It is compiled with
``ops/_build.py``'s nvcc flags into ``build/match_variants/<name>/``, its
ptxas report for the match kernel (registers, stack frame, spills) is kept,
and it runs ``match_time``'s cases in place of the default build: each
record says whether its lengths and lags equal the default build's on every
position (a variant that drops work may not), and its time is taken the
same way. The default (the source as it is) is built the
same way and timed first and last, so the spread of one build's time shows
beside the variants'. Writes
``build/probes/match_variants.json`` and prints one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess

from pim_compression_tpu_torch.ops import _build
from pim_compression_tpu_torch.scripts import common, match_time

# name -> {constant: value}. kHeld ranges over [kSteps / 2, kSteps], kSteps = 32768 / kMaxThreads.
VARIANTS = {
    "1024-threads-32-held": {"kHeld": 32},
    "512-threads-32-held": {"kMaxThreads": 512, "kHeld": 32},
    "512-threads-64-held": {"kMaxThreads": 512, "kHeld": 64},
    "no-sort": {"kPasses": 0},  # drops the radix passes: wrong output, the time without the sort
}


def build_variants(variants: dict, source: str = "match.cu", csrc=None) -> dict:
    """name -> (the loaded library, ptxas's lines on the kernel) of each
    variant of ``csrc/<source>`` (whose kernel is ``<stem>_blocks_kernel``
    and whose C entry is ``pim_<stem>_blocks``), compiled all at once into
    ``build/<stem>_variants/<name>/``, one nvcc each. ``csrc`` is the
    directory of the sources (default: this checkout's ``csrc/``), so
    another checkout's kernel builds the same way."""
    import ctypes

    csrc = _build.CSRC_DIR if csrc is None else pathlib.Path(csrc)
    stem = source.split(".")[0]
    entry = f"pim_{stem}_blocks"
    commands, libs = [], {}
    for name, consts in variants.items():
        src = (csrc / source).read_text()
        for const, value in consts.items():
            src, n = re.subn(rf"constexpr int {const} = [^;]+;", f"constexpr int {const} = {value};", src)
            if n != 1:
                raise ValueError(f"{source} has no one constant {const}")
        out = _build.BUILD_DIR.parent / f"{stem}_variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, out / header.name)
        (out / source).write_text(src)
        libs[name] = out / f"lib{stem}.so"
        commands.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(libs[name]), str(out / source)])
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in commands]
    typed = getattr(_build.load(), entry)
    built = {}
    for (name, lib), proc in zip(libs.items(), procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lines = log.splitlines()
        ats = [i for i, line in enumerate(lines) if f"{stem}_blocks_kernel" in line and "Compiling" in line]
        handle = ctypes.CDLL(str(lib))
        getattr(handle, entry).restype, getattr(handle, entry).argtypes = typed.restype, typed.argtypes
        # One report per instance of the kernel (the sweep's is a template of its mode).
        built[name] = handle, " || ".join(" | ".join(line.strip() for line in lines[at + 1 : at + 4]) for at in ats)
    return built


def run(device) -> list[dict]:
    dev = common.cuda_device(device)
    todo = match_time.cases()
    default = _build.load()
    builds = build_variants({"default": {}, **VARIANTS})
    common.warm(dev)
    out, want = [{"card": common.card(dev)}], None
    try:
        for name in ["default", *VARIANTS, "default"]:
            handle, ptxas = builds[name]
            _build._lib = handle  # hopper_match.match_blocks launches through _build.load()
            records, outputs = match_time.time_cases(dev, todo, check=want)
            want = want or outputs
            out.append({"variant": name, "consts": VARIANTS.get(name, {}), "ptxas": ptxas, "cases": records})
    finally:
        _build._lib = default
    return out


def main(argv=None) -> int:
    rc = common.main("match_variants", run, __doc__.splitlines()[0], argv)
    print(json.dumps(json.loads((common.OUT_DIR / "match_variants.json").read_text())))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
