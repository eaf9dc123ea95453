"""ctypes bindings for the C++ native host codec (the port's own copy of
``pim_compression_tpu.native``, the same C++ source and C interface).

Builds the library with ``g++`` on first use into ``build/native/`` at the
checkout root (listed in ``.gitignore``), under a name that hashes the
source and flags, so a changed source rebuilds. Nothing is built into the
package directory. Falls back cleanly: callers can check :func:`available`
and use the pure-Python oracle instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

from pim_compression_tpu_torch.format import constants as C
from pim_compression_tpu_torch.utils.errors import SnappyError, SnappyStatus

_DIR = pathlib.Path(__file__).resolve().parent
_SRC_PATH = _DIR / "snappy_native.cpp"
BUILD_DIR = _DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread")

_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC_PATH.read_bytes())
    return BUILD_DIR / f"libsnappy_native_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> None:
    """Compile into a temporary name and move it into place, so processes
    that build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(_SRC_PATH)],
            check=True,
            capture_output=True,
            text=True,
        )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.CalledProcessError) as e:
        _build_error = str(e)
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.stpu_max_compressed_length.restype = ctypes.c_int64
    lib.stpu_max_compressed_length.argtypes = [ctypes.c_int64, ctypes.c_uint32]
    lib.stpu_compress.restype = ctypes.c_int64
    lib.stpu_compress.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_uint32, u8p, ctypes.c_int64, ctypes.c_int
    ]
    lib.stpu_decompress.restype = ctypes.c_int64
    lib.stpu_decompress.argtypes = [
        u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int
    ]
    lib.stpu_peek_header.restype = ctypes.c_int64
    lib.stpu_peek_header.argtypes = [u8p, ctypes.c_int64, u32p, u32p, i64p]
    lib.stpu_scan_frames.restype = ctypes.c_int64
    lib.stpu_scan_frames.argtypes = [
        u8p, ctypes.c_int64, i64p, u32p, i64p, u32p, ctypes.c_int64
    ]
    lib.stpu_blockize_compressed.restype = ctypes.c_int64
    lib.stpu_blockize_compressed.argtypes = [
        u8p, ctypes.c_int64, i64p, u32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int
    ]
    lib.stpu_parallel_copy.restype = ctypes.c_int64
    lib.stpu_parallel_copy.argtypes = [u8p, u8p, ctypes.c_int64, ctypes.c_int]
    lib.stpu_assemble_compressed.restype = ctypes.c_int64
    lib.stpu_assemble_compressed.argtypes = [
        u8p, ctypes.c_int64, u32p, ctypes.c_int64, u8p, ctypes.c_int64,
        ctypes.c_int
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


_pba_new = ctypes.pythonapi.PyByteArray_FromStringAndSize
_pba_new.restype = ctypes.py_object
_pba_new.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]


def uninit_bytearray(n: int) -> bytearray:
    """bytearray(n) without the zero-fill pass (CPython documents NULL
    contents as uninitialized) — callers overwrite every byte."""
    return _pba_new(None, n)


def _check(status: int) -> int:
    if status < 0:
        raise SnappyError(SnappyStatus(status))
    return status


def compress(
    data: bytes,
    block_size: int = C.DEFAULT_BLOCK_SIZE,
    num_threads: int = 0,
) -> bytes:
    """Compress via the native codec; byte-identical to the oracle's output.

    ``num_threads`` 0 means use all CPUs; 1 means sequential (the reference
    host path's behavior).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    src = np.frombuffer(data, dtype=np.uint8)
    cap = _check(lib.stpu_max_compressed_length(len(data), block_size))
    out = np.empty(cap, dtype=np.uint8)
    n = _check(
        lib.stpu_compress(
            _as_u8p(src) if len(data) else _as_u8p(out),
            len(data),
            block_size,
            _as_u8p(out),
            cap,
            num_threads,
        )
    )
    return out[:n].tobytes()


def decompress(stream: bytes, num_threads: int = 0) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    src = np.frombuffer(stream, dtype=np.uint8)
    total = ctypes.c_uint32()
    block_size = ctypes.c_uint32()
    num_blocks = ctypes.c_int64()
    _check(
        lib.stpu_peek_header(
            _as_u8p(src),
            len(stream),
            ctypes.byref(total),
            ctypes.byref(block_size),
            ctypes.byref(num_blocks),
        )
    )
    out = np.empty(max(total.value, 1), dtype=np.uint8)
    n = _check(
        lib.stpu_decompress(
            _as_u8p(src), len(stream), _as_u8p(out), len(out), num_threads
        )
    )
    return out[:n].tobytes()


def blockize_compressed(
    stream: bytes,
    payload_off: np.ndarray,
    payload_size: np.ndarray,
    comp: np.ndarray,
    dirty_bytes: int = 0,
    num_threads: int = 0,
) -> None:
    """Fill the padded ``comp[num_blocks_padded, cap]`` slot matrix with the
    framed payloads — one parallel memcpy per block (the host pre-phase of
    the TPU decode path). Bytes of ``comp`` below ``dirty_bytes`` that no
    payload covers are zeroed; pass 0 for a freshly zeroed buffer."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    nb = len(payload_off)
    src = np.frombuffer(stream, dtype=np.uint8)
    off64 = np.ascontiguousarray(payload_off, dtype=np.int64)
    size32 = np.ascontiguousarray(payload_size, dtype=np.uint32)
    assert comp.dtype == np.uint8 and comp.flags.c_contiguous
    assert comp.shape[0] >= nb
    _check(
        lib.stpu_blockize_compressed(
            _as_u8p(src),
            len(stream),
            off64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            size32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            nb,
            comp.shape[0],
            comp.shape[1],
            dirty_bytes,
            _as_u8p(comp),
            num_threads,
        )
    )


def parallel_copy(dst, src, num_threads: int = 0) -> None:
    """Chunked multi-thread memcpy between buffer-protocol objects."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    d = np.frombuffer(dst, dtype=np.uint8)
    s = np.frombuffer(src, dtype=np.uint8)
    assert len(d) >= len(s)
    lib.stpu_parallel_copy(_as_u8p(d), _as_u8p(s), len(s), num_threads)


def assemble_compressed(
    comp: np.ndarray,
    sizes: np.ndarray,
    header: bytes,
    num_threads: int = 0,
) -> bytearray:
    """Header + per-block u32 frames + payload compaction — one parallel
    memcpy per block (the host post-phase of the TPU encode path; the
    ordered-fwrite analog, ``snappy_compress.c:697-703``).

    Returns a ``bytearray`` the C layer filled IN PLACE (the stream is
    written exactly once — an immutable ``bytes`` return would force a
    second full pass just to detach the buffer; bytearray compares,
    slices, and writes like bytes everywhere the runtime uses streams).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    if num_threads == 0:
        num_threads = os.cpu_count() or 1
    nb = len(sizes)
    sizes32 = np.ascontiguousarray(sizes, dtype=np.uint32)
    assert comp.dtype == np.uint8 and comp.flags.c_contiguous
    total = len(header) + int(sizes32.astype(np.int64).sum()) + 4 * nb
    out = uninit_bytearray(total)
    out[: len(header)] = header
    cbuf = (ctypes.c_uint8 * total).from_buffer(out)
    wrote = _check(
        lib.stpu_assemble_compressed(
            _as_u8p(comp),
            comp.shape[1],
            sizes32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            nb,
            ctypes.cast(
                ctypes.byref(cbuf, len(header)),
                ctypes.POINTER(ctypes.c_uint8),
            ),
            total - len(header),
            num_threads,
        )
    )
    del cbuf  # release the bytearray's exported-buffer lock
    assert wrote == total - len(header)
    return out


def scan_frames(stream: bytes) -> dict:
    """Native-speed frame scan (host pre-pass for the TPU decode path).

    Returns dict with total_len, block_size, and per-block numpy arrays:
    payload_off, payload_size, out_off, out_size.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    src = np.frombuffer(stream, dtype=np.uint8)
    total = ctypes.c_uint32()
    block_size = ctypes.c_uint32()
    num_blocks = ctypes.c_int64()
    _check(
        lib.stpu_peek_header(
            _as_u8p(src),
            len(stream),
            ctypes.byref(total),
            ctypes.byref(block_size),
            ctypes.byref(num_blocks),
        )
    )
    nb = num_blocks.value
    payload_off = np.empty(nb, dtype=np.int64)
    payload_size = np.empty(nb, dtype=np.uint32)
    out_off = np.empty(nb, dtype=np.int64)
    out_size = np.empty(nb, dtype=np.uint32)
    got = _check(
        lib.stpu_scan_frames(
            _as_u8p(src),
            len(stream),
            payload_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            payload_size.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            out_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_size.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            nb,
        )
    )
    assert got == nb
    return {
        "total_len": total.value,
        "block_size": block_size.value,
        "payload_off": payload_off,
        "payload_size": payload_size,
        "out_off": out_off,
        "out_size": out_size,
    }
