"""The kernel build: sources, cache key and failure, checked without nvcc."""

from __future__ import annotations

import shutil

import pytest
import torch

from pim_compression_tpu_torch.ops import _build

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)


def test_sources_are_the_csrc_kernels():
    names = [p.name for p in _build._sources()]
    assert {"decode.cu", "match.cu", "emit.cu", "sweep.cu", "probes.cu", "staging.cuh", "radix.cuh"} <= set(names)
    assert all(p.parent == _build.CSRC_DIR for p in _build._sources())
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_library_name_hashes_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libpim_kernels_")
    (csrc / "decode.cu").write_text((csrc / "decode.cu").read_text() + "\n// changed\n")
    assert _build.library_path() != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    # No fallback: a missing compiler is an error, and nothing is left behind.
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not list((tmp_path / "kernels").glob("*.so"))


def test_failed_compile_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'decode.cu: error: refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="refused"):
        _build.build()
    assert not list((tmp_path / "kernels").iterdir())


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    # One compile per .cu source (started together), then one link; headers
    # are not compiled on their own. A stand-in nvcc records its arguments.
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift; done\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    path = _build.build()
    assert path.exists() and path == _build.library_path()
    calls = log.read_text().splitlines()
    units = sorted(p.name for p in _build._sources() if p.suffix == ".cu")
    compiles = sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[1] for c in calls if " -c " in c)
    assert compiles == units
    links = [c for c in calls if "-shared" in c]
    assert len(links) == 1 and len(calls) == len(units) + 1
    assert [p.name for p in (tmp_path / "kernels").iterdir()] == [path.name]  # objects removed
