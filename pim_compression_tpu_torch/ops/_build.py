"""Build and bind the port's CUDA kernels.

At first use, ``nvcc`` compiles every source in ``csrc/`` into an object
file, one process per source, all started together, and links the objects
into one shared library with a plain C interface, loaded with ctypes. The
library lands in ``build/kernels/`` at the checkout root (listed in
``.gitignore``) under a name that hashes the sources and flags, so a changed
source rebuilds and an unchanged one loads at once. A build failure raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lib: ctypes.CDLL | None = None
# nvcc's output from the build this process ran (ptxas register and
# shared-memory report); empty when the library was already built.
build_log = ""


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpim_kernels_{h.hexdigest()[:16]}.so"


def _run_all(commands: list[list[str]]) -> str:
    """Run the commands at once; raise with their output if any fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    outs = [proc.communicate()[0] for proc in procs]
    failed = [(proc.returncode, out) for proc, out in zip(procs, outs) if proc.returncode != 0]
    if failed:
        raise RuntimeError("".join(f"nvcc failed ({rc}):\n{out}" for rc, out in failed))
    return "".join(outs)


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the hashed library exists; return its path."""
    global build_log
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    units = [p for p in _sources() if p.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in units]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o] for p, o in zip(units, objs)])
        lib = os.path.join(tmp, path.name)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        os.replace(lib, path)
    build_log = log
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pim_decode_blocks.restype = i32
        lib.pim_decode_blocks.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # comp, comp_len, out_len, out, err
            i32, i32, i32, i32,  # num_blocks, cap, block_size, device
            ptr, ptr,  # stream, trace record (null: the plain kernel)
        ]
        lib.pim_decode_walks_per_sm.restype = i32
        lib.pim_decode_walks_per_sm.argtypes = [i32]  # device
        lib.pim_match_blocks.restype = i32
        lib.pim_match_blocks.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # blocks, lens, mlen, mlag, near, first_half, last_idx
            i32, i32, i32, i32, i32, i32,  # num_blocks, block_size, rung_mask, ext_cap, neighbor, max_lag
            i32, i32, i32, i32, i32,  # prev_k, sel_cap, mode, stride_code, window
            i32, ptr, ptr,  # device, stream, trace record (null: the plain kernel)
        ]
        lib.pim_sweep_blocks.restype = i32
        lib.pim_sweep_blocks.argtypes = [
            ptr, ptr, ptr, ptr,  # blocks, lens, mlen, mlag
            i32, i32, i32, i32, i32,  # num_blocks, block_size, window, coarse, granular
            i32, ptr, ptr,  # device, stream, trace record (null: the plain kernel)
        ]
        lib.pim_sweep_ctas_per_sm.restype = i32
        lib.pim_sweep_ctas_per_sm.argtypes = [i32, i32]  # block_size, device
        lib.pim_emit_blocks.restype = i32
        lib.pim_emit_blocks.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # blocks, lens, mlen, mlag, comp, sizes
            i32, i32, i32,  # num_blocks, block_size, cap
            i32, ptr, ptr,  # device, stream, trace record (null: the plain kernel)
        ]
        for chain in (lib.pim_probe_gather_chain, lib.pim_probe_ew_chain):
            chain.restype = i32
            chain.argtypes = [ptr, ptr, ptr, i32, i32, ptr]  # x, idx, out, iters, device, stream
        lib.pim_probe_copy_rows.restype = i32
        lib.pim_probe_copy_rows.argtypes = [ptr, ptr, i32, i32, i32, ptr]  # x, out, in_rows, out_rows, device, stream
        lib.pim_probe_mix_rounds.restype = i32
        lib.pim_probe_mix_rounds.argtypes = [
            ptr, ptr, i32, i32, i32,  # x, out, rows, iters, from_row0
            i32, ptr,  # device, stream
        ]
        lib.pim_clock_calibrate.restype = i32
        lib.pim_clock_calibrate.argtypes = [i32, i32, ptr]  # device, tries, out (int64[3 * tries])
        _lib = lib
    return _lib
