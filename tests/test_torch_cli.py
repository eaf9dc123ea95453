"""The port's CLI (``python -m pim_compression_tpu_torch``), mirroring ``test_cli.py``.

The flags, the stdout contract, the exit codes and ``--preset`` on the
``torch``, ``native`` and ``oracle`` engines with generated inputs (the
reference corpus is not needed), the ``cuda`` engine refusing to run
without a GPU, and the port's stream against the JAX CLI's for the same
flags. The CLI on the GPU is in ``test_torch_cuda.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pim_compression_tpu.format import oracle
from pim_compression_tpu_torch import cli, native
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ENGINES = ["torch", "native", "oracle"]


def _env(tmp_path) -> dict:
    # The JAX CLI keeps its compilation cache where this names it.
    return dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax-cache"))


@pytest.fixture
def text(tmp_path) -> pathlib.Path:
    src = tmp_path / "in.txt"
    src.write_bytes(streams.text_payload(8 * 1024 + 123, 17))
    return src


@pytest.fixture(params=ENGINES)
def engine(request):
    if request.param == "native" and not native.available():
        pytest.skip("the native host codec is not built")
    return request.param


def test_cli_round_trip_and_block_size(engine, text, tmp_path, capsys):
    comp, out = tmp_path / "c.snappy", tmp_path / "rt.txt"
    assert cli.main(["-c", "-b", "1024", "--engine", engine, "-i", str(text), "-o", str(comp)]) == 0
    assert oracle.decompress(comp.read_bytes()) == text.read_bytes()
    assert cli.main(["--engine", engine, "-i", str(comp), "-o", str(out)]) == 0
    assert out.read_bytes() == text.read_bytes()
    lines = capsys.readouterr().out.splitlines()
    # Decompression reports the stream's own block size, not the -b default.
    assert f"Using {engine} engine for compression (block size 1024)" in lines
    assert f"Using {engine} engine for decompression (block size 1024)" in lines


def test_cli_stdout_contract_and_json(engine, text, tmp_path, capsys):
    comp = tmp_path / "c.snappy"
    assert cli.main(["-c", "-b", "2048", "--engine", engine, "-i", str(text), "-o", str(comp), "--json"]) == 0
    out = capsys.readouterr().out
    ratio = [line for line in out.splitlines() if line.startswith("Compression ratio:")]
    original, compressed = text.stat().st_size, comp.stat().st_size
    assert ratio == [f"Compression ratio: {1.0 - compressed / original:.6f}"]
    assert "kernel time:" in out and "Total time:" in out
    m = json.loads([line for line in out.splitlines() if line.startswith("{")][0])
    assert (m["engine"], m["mode"], m["block_size"]) == (engine, "compression", 2048)
    assert (m["original_bytes"], m["compressed_bytes"]) == (original, compressed)


@pytest.mark.parametrize(
    "argv, code, words",
    [
        (["-i", "nope.bin"], 2, "not found"),
        (["-c", "-b", "999999", "--engine", "torch"], 2, "block_size"),
        (["-c", "--engine", "torch", "--rungs", "4,12"], 2, "rungs"),
        (["-c", "--engine", "torch", "--rung-strides", "1,x"], 2, "invalid literal"),
        (["-c", "-b", "1024", "--engine", "torch", "--sort-window", "2048"], 2, "padded sort size"),
        (["-c", "-b", "1000", "--engine", "torch", "--strict-engine"], 2, "multiple of 128"),
        (["--engine", "torch", "-b", "1024"], 1, "error"),  # the input is no stream
    ],
    ids=["missing-input", "bad-block-size", "bad-rungs", "bad-strides", "window-past-block", "bs-1000",
         "corrupt-stream"],
)
def test_cli_exit_codes(argv, code, words, text, tmp_path, capsys):
    argv = [a if a != "nope.bin" else str(tmp_path / a) for a in argv]
    if "-i" not in argv:
        argv += ["-i", str(text)]
    out = tmp_path / "out.bin"
    assert cli.main([*argv, "-o", str(out)]) == code
    assert words in capsys.readouterr().err
    assert not out.exists()


def test_cli_corrupt_stream_is_a_codec_error(tmp_path, capsys):
    bad = tmp_path / "bad.snappy"
    bad.write_bytes(b"\xff" * 40)
    assert cli.main(["--engine", "oracle", "-i", str(bad), "-o", str(tmp_path / "o")]) == 1
    assert "error" in capsys.readouterr().err


def _parsed_config(*argv):
    args = cli.build_parser().parse_args([*argv, "-i", "x"])
    return cli._config(args, args.b or 32768, args.engine or "cuda")


def test_cli_preset_and_explicit_flags():
    # A preset sets its knobs; an explicit flag wins over it, also at the
    # value that is the config's default (the JAX CLI lets the preset win then).
    speed = _parsed_config("--preset", "speed")
    assert (speed.max_lag, speed.sweep_span) == (5120, 16)
    assert _parsed_config("--preset", "speed", "--max-lag", "1024").max_lag == 1024
    assert _parsed_config("--preset", "speed", "--max-lag", "-1").max_lag == -1
    wide = _parsed_config("--preset", "balanced", "-b", "65536")
    assert (wide.rungs, wide.prev_k, wide.sel_cap, wide.sel_all) == ((4,), 2, 16, True)
    assert _parsed_config("--preset", "balanced", "-b", "65536", "--rungs", "4,16").rungs == (4, 16)
    plain = _parsed_config()
    assert (plain.engine, plain.rungs, plain.rung_pick, plain.sel_all) == ("cuda", (4, 16), True, False)
    assert _parsed_config("--rungs", "full").rungs is None
    assert _parsed_config("--sel-all").sel_all is False  # as in the JAX CLI: no cap, no sel_all
    knobs = _parsed_config("--rungs", "4,32", "--rung-strides", "1,8", "--sort-window", "8192", "--no-rung-pick",
                           "--prev-k", "6", "--sel-cap", "16", "--sel-all", "--stride2-min", "16")
    assert (knobs.rung_strides, knobs.sort_window, knobs.rung_pick, knobs.prev_k, knobs.sel_all,
            knobs.stride2_min) == ((1, 8), 8192, False, 6, True, 16)


def test_cli_preset_compresses(text, tmp_path):
    out = tmp_path / "p.snappy"
    argv = ["-c", "--engine", "torch", "-b", "1024", "--preset", "speed", "--max-lag", "1024"]
    assert cli.main([*argv, "-i", str(text), "-o", str(out)]) == 0
    assert oracle.decompress(out.read_bytes()) == text.read_bytes()


@pytest.mark.parametrize("extra", [[], ["-d"], ["--engine", "cuda"], ["--engine", "cuda", "--debug-block", "0"]],
                         ids=["default", "d-flag", "engine-cuda", "debug-dump"])
def test_cli_cuda_engine_needs_a_gpu(extra, text, tmp_path, monkeypatch, capsys):
    # The default engine is cuda: without a GPU it fails and writes nothing.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "c.snappy"
    assert cli.main(["-c", "-b", "1024", *extra, "-i", str(text), "-o", str(out)]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not out.exists() and not (tmp_path / "pim_debug_block.npz").exists()


def test_cli_debug_dump_refuses_the_plain_engines(text, tmp_path, capsys, monkeypatch):
    # The dump holds the plain versions against the CUDA kernels: on the
    # torch engine it would compare the plain version with itself.
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-c", "-b", "1024", "--engine", "torch", "--debug-block", "0", "-i", str(text)]) == 2
    assert "needs the cuda engine" in capsys.readouterr().err
    assert not (tmp_path / "pim_debug_block.npz").exists()


def test_cli_stream_equals_the_jax_cli(text, tmp_path):
    # Both CLIs as users run them, with the same matcher flags: strided rung
    # sorts, the capped select and the per-rung ladder. The JAX CLI's -d
    # runs the Pallas kernels, in interpret mode on the CPU.
    flags = ["-c", "-b", "1024", "--rungs", "4,16", "--stride2-min", "16", "--prev-k", "2", "--sel-cap", "16"]
    runs = {
        "pim_compression_tpu.cli": ["-d"],
        "pim_compression_tpu_torch": ["--engine", "torch"],
    }
    out = {}
    for module, engine in runs.items():
        dst = tmp_path / f"{module}.snappy"
        proc = subprocess.run(
            [sys.executable, "-m", module, *flags, *engine, "-i", str(text), "-o", str(dst)],
            capture_output=True, text=True, cwd=tmp_path, env=_env(tmp_path), timeout=300,
        )
        assert proc.returncode == 0, proc.stderr
        out[module] = dst.read_bytes()
    assert out["pim_compression_tpu_torch"] == out["pim_compression_tpu.cli"]
    assert oracle.decompress(out["pim_compression_tpu_torch"]) == text.read_bytes()


def test_cli_fresh_process_leaves_jax_out(text, tmp_path):
    # `python -m pim_compression_tpu_torch.cli` in a fresh process: a
    # compress and a decompress load neither JAX nor the JAX package.
    code = (
        "import runpy, sys\n"
        "for argv in ({c!r}, {d!r}):\n"
        "    sys.argv = ['cli', *argv]\n"
        "    try:\n"
        "        runpy.run_module('pim_compression_tpu_torch.cli', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'pim_compression_tpu']\n"
        "assert not ref, ref\n"
    ).format(
        c=["-c", "-b", "1024", "--engine", "torch", "--rungs", "full", "--stride2-min", "16", "--prev-k", "3",
           "--sort-window", "512", "-i", str(text), "-o", str(tmp_path / "c.snappy")],
        d=["--engine", "torch", "-i", str(tmp_path / "c.snappy"), "-o", str(tmp_path / "rt.txt")],
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path,
                          env=_env(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "rt.txt").read_bytes() == text.read_bytes()
