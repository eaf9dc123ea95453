"""Build the JAX package's native host codec once, before pytest-xdist starts its workers.

``pim_compression_tpu.native`` builds ``libsnappy_native.so`` with ``make``
at first use, writing the library in place. Under ``-n N`` every worker
imports ``tests/test_native.py`` at collection, and its module-level
``skipif(not native.available())`` runs that build in all of them at once:
a worker whose ``make`` finds another's half-written library up to date
fails to load it, and then skips the module's tests. Building it here, in
the controlling process and under a file lock, leaves a whole library that
every worker finds up to date, so each run counts the same tests.
"""

from __future__ import annotations

import fcntl
import pathlib
import subprocess

_ROOT = pathlib.Path(__file__).resolve().parent
_NATIVE = _ROOT / "pim_compression_tpu" / "native"


def pytest_configure(config):
    if hasattr(config, "workerinput") or not config.getoption("numprocesses", None):
        return  # an xdist worker, or a run without workers: no race to prevent
    lock_dir = _ROOT / "build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / "native_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # The loader's own build step; a failure (or no make) leaves the
        # loader to try and report it as it always has.
        try:
            subprocess.run(["make", "-s", "-C", str(_NATIVE)], capture_output=True, check=False)
        except OSError:
            pass
