"""The port's CUDA kernels (decode, match, sweep, emit, the probes) and devbench, on a GPU.

Every test here needs a CUDA device and nvcc, carries the ``cuda`` marker
and skips without a device. The file imports no JAX, so it also runs where
only PyTorch is installed:

    python3 -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: the decode kernel by verdicts on every block and bytes on valid
blocks, the match and emit kernels exactly (every length, lag, size and
byte), the probe kernels exactly; and the engines against the plaintext.
"""

from __future__ import annotations

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from pim_compression_tpu import native
from pim_compression_tpu.format import oracle
from pim_compression_tpu_torch import TorchCodecConfig, runtime
from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _compress(data: bytes, block_size: int) -> bytes:
    return native.compress(data, block_size) if native.available() else oracle.compress(data, block_size)


def _blocks(stream: bytes):
    info = pipeline.scan_frames(stream)
    return [
        (stream[o : o + s], int(n))
        for o, s, n in zip(info["payload_off"], info["payload_size"], info["out_size"])
    ]


def _on_device(blocks, block_size, device):
    cap = pipeline.padded_capacity(block_size)
    comp = np.zeros((len(blocks), cap), np.uint8)
    clen = np.zeros(len(blocks), np.int32)
    olen = np.zeros(len(blocks), np.int32)
    for i, (payload, out_len) in enumerate(blocks):
        comp[i, : len(payload)] = np.frombuffer(payload, np.uint8)
        clen[i], olen[i] = len(payload), out_len
    return tuple(torch.from_numpy(a).to(device) for a in (comp, clen, olen))


@pytest.mark.parametrize("block_size", [256, 4096, 24576, 65536])
def test_cuda_kernel_matches_plain_version(cuda_device, block_size):
    stream = _compress(streams.text_payload(6 * block_size + 99, block_size), block_size)
    base = streams.hand_blocks(block_size) + _blocks(stream)
    if block_size > 32768:  # copies at offsets above 32768
        base += _blocks(_compress(streams.far_repeat_block(block_size, 1), block_size))
    blocks = base + streams.block_mutants(base, random.Random(block_size), 48, block_size)
    args = _on_device(blocks, block_size, cuda_device)
    launches = hopper_decode.LAUNCHES
    out_k, err_k = hopper_decode.decode_blocks(*args, block_size=block_size)
    torch.cuda.synchronize()
    assert hopper_decode.LAUNCHES == launches + 1
    out_p, err_p = hopper_decode.decode_blocks_torch(*args, block_size)
    assert torch.equal(err_k != 0, err_p != 0)
    valid = err_k == 0
    assert valid[: len(base)].all()
    assert torch.equal(out_k[valid], out_p[valid])


def test_cuda_kernel_decodes_32k_stream(cuda_device):
    data = streams.text_payload(40 * 32768 + 5000, 3)
    blocks = _blocks(_compress(data, 32768))
    out, err = hopper_decode.decode_blocks(*_on_device(blocks, 32768, cuda_device), block_size=32768)
    assert not err.any()
    flat = out.cpu().numpy().reshape(-1)[: len(data)]
    assert flat.tobytes() == data


@pytest.mark.parametrize("block_size", [40960, 65536])
def test_cuda_kernel_decodes_64k_stream(cuda_device, block_size):
    data = streams.text_payload(20 * 65536 + 5000, 3) + streams.far_repeat_block(65536, 2)
    blocks = _blocks(_compress(data, block_size))
    out, err = hopper_decode.decode_blocks(*_on_device(blocks, block_size, cuda_device), block_size=block_size)
    assert not err.any()
    flat = out.cpu().numpy().reshape(-1)[: len(data)]
    assert flat.tobytes() == data


def test_cuda_kernel_rejects_bad_tensors(cuda_device):
    comp = torch.zeros((4, 768), dtype=torch.uint8, device=cuda_device)
    lens = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        hopper_decode.decode_blocks(comp[:, ::2], lens, lens, block_size=256)
    with pytest.raises(ValueError):  # mixed devices
        hopper_decode.decode_blocks(comp, lens.cpu(), lens, block_size=256)
    big = torch.zeros((1, 200000), dtype=torch.uint8, device=cuda_device)
    one = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # payload + block exceed shared memory
        hopper_decode.decode_blocks(big, one, one, block_size=32768)


def test_cuda_engine_round_trip(cuda_device):
    data = streams.text_payload(5 * 32768 + 1234, 77)
    stream = _compress(data, 32768)
    launches = hopper_decode.LAUNCHES
    out = runtime.decompress(stream, TorchCodecConfig(engine="cuda", batch_blocks=2))
    assert bytes(out) == data
    assert hopper_decode.LAUNCHES == launches + 3  # batches of 2, 2 and 2 blocks


MAIN = dict(rungs=(4, 16), ext_cap=48, neighbor=True, max_lag=8192)
# The 64 KB rows: the zero-flag config after the switch to the select
# ladder, and the presets' rungs=(4,), prev_k=2 (max_lag 0 or 16384).
WIDE = dict(rungs=(4, 16), ext_cap=48, neighbor=True, max_lag=0, sel_cap=16, sel_all=True)
PRESET = dict(rungs=(4,), ext_cap=48, neighbor=True, max_lag=16384, prev_k=2, sel_cap=16, sel_all=True)
# The sort modes and the per-rung ladder (as encode_knobs gives them): (a)
# the capped per-rung ladder with half-density long rungs, (b) the uncapped
# ladder, (c) the windowed rung pick, (d) sel_all at strides (1, 8), (e) at
# 64 KB the stride-2 rung's 17-bit keys and the window.
LADDER_A = dict(rungs=(4, 8, 16, 32, 64), strides=(1, 1, 2, 2, 2), prev_k=4, sel_cap=16, rung_pick=False,
                ext_cap=48, neighbor=True, max_lag=8192)
LADDER_B = dict(MAIN, prev_k=6, rung_pick=False)
WINDOW_C = dict(MAIN, sort_window=8192)
STRIDES_D = dict(MAIN, rungs=(4, 32), strides=(1, 8), prev_k=2, sel_cap=16, sel_all=True)
WIDE_E = dict(WIDE, rungs=(4, 32), strides=(1, 2), sort_window=16384)


@pytest.mark.parametrize(
    "block_size, knobs",
    [(256, MAIN), (4096, MAIN), (24576, MAIN), (32768, MAIN),
     (4096, dict(rungs=(4, 8, 16, 32, 64), ext_cap=64, neighbor=False, max_lag=0)),
     (4096, dict(PRESET, rungs=(4, 8, 64), prev_k=4, sel_cap=8, max_lag=300)),
     (32768, PRESET), (40960, WIDE), (65536, WIDE), (65536, PRESET), (65536, MAIN),
     (32768, LADDER_A), (4096, dict(LADDER_A, sort_window=1024)), (32768, LADDER_B), (32768, WINDOW_C),
     (24576, WINDOW_C), (32768, STRIDES_D), (65536, WIDE_E), (40960, WIDE_E), (65536, dict(WIDE_E, sort_window=0)),
     (65536, dict(LADDER_B, strides=(1, 4), sort_window=512)), (1024, dict(MAIN, strides=(1, 8), sort_window=512)),
     (32768, dict(MAIN, sort_window=512)), (49152, MAIN)],
    ids=["256", "4096", "24576", "32768", "4096-all-rungs", "4096-ladder", "32768-ladder",
         "40960-wide", "65536-wide", "65536-preset", "65536-rung-pick",
         "32768-a", "4096-a-window", "32768-b", "32768-c", "24576-c", "32768-d", "65536-e", "40960-e",
         "65536-e-no-window", "65536-ladder-window-512", "1024-window-strided",
         "32768-window-512", "49152-partial-second-half"],
)
def test_cuda_encode_kernels_match_plain_versions(cuda_device, block_size, knobs):
    n = 300 if block_size <= 4096 else 40
    rb, rl = streams.plain_blocks(block_size, n, block_size)
    hb, hl = streams.hand_plain_blocks(block_size, block_size)
    text = np.frombuffer(streams.text_payload(8 * block_size, 5), np.uint8).reshape(8, block_size)
    far = np.frombuffer(streams.far_repeat_block(block_size, 3), np.uint8)[None]
    blocks = torch.from_numpy(np.concatenate([rb, hb, text, far])).to(cuda_device)
    lens = torch.from_numpy(np.concatenate([rl, hl, np.full(9, block_size, np.int32)])).to(cuda_device)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    mlen, mlag = hopper_match.match_blocks(blocks, lens, **knobs)
    cap = pipeline.padded_capacity(block_size)
    comp, sizes = hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap)
    torch.cuda.synchronize()
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == (launches[0] + 1, launches[1] + 1)
    want_len, want_lag = hopper_match.match_blocks_torch(blocks, lens, **knobs)
    assert torch.equal(mlen, want_len) and torch.equal(mlag, want_lag)
    want_comp, want_sizes = hopper_encode.emit_blocks_torch(blocks, lens, mlen, mlag, cap)
    assert torch.equal(sizes, want_sizes) and torch.equal(comp, want_comp)


def test_cuda_encode_wrappers_reject_bad_tensors(cuda_device):
    blocks = torch.zeros((4, 512), dtype=torch.uint8, device=cuda_device)
    lens = torch.full((4,), 512, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        hopper_match.match_blocks(blocks[:, ::2], lens)
    with pytest.raises(ValueError):  # mixed devices
        hopper_match.match_blocks(blocks, lens.cpu())
    mlen, mlag = hopper_match.match_blocks(blocks, lens)
    # A cap far past the block: the emit stages a window and a ring of its
    # own size, so no cap is refused for shared memory.
    comp, sizes = hopper_encode.emit_blocks(blocks, lens, mlen, mlag, 250000)
    want_comp, want_sizes = hopper_encode.emit_blocks_torch(blocks, lens, mlen, mlag, 250000)
    assert torch.equal(sizes, want_sizes) and torch.equal(comp, want_comp)


@pytest.mark.parametrize("block_size", [256, 8192, 32768, 65536])
@pytest.mark.parametrize("odd_cap", [False, True], ids=["cap16", "odd-cap"])
def test_cuda_emit_kernel_on_synthetic_matches(cuda_device, block_size, odd_cap):
    # Literal runs longer than the kernel's window, 64-byte copies across
    # its refill margin, lags from 32768 up, lengths past lens, an empty
    # block, 7 blocks (not a whole CTA of warps), and a cap below the larger
    # sizes: 16-byte stores, or bytes at a cap that is not a multiple of 16.
    arrays = streams.synthetic_matches(block_size, block_size * 2 + odd_cap)
    blocks, lens, mlen, mlag = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    cap = block_size // 2 + (5 if odd_cap else 16)
    launches = hopper_encode.LAUNCHES
    comp, sizes = hopper_encode.emit_blocks(blocks, lens, mlen, mlag, cap)
    torch.cuda.synchronize()
    assert hopper_encode.LAUNCHES == launches + 1
    want_comp, want_sizes = hopper_encode.emit_blocks_torch(blocks, lens, mlen, mlag, cap)
    assert (want_sizes > cap).any() and int(want_sizes[3]) == 0
    assert torch.equal(sizes, want_sizes) and torch.equal(comp, want_comp)


def test_cuda_engine_compress_round_trip(cuda_device):
    rng = np.random.default_rng(8)
    text = streams.text_payload(6 * 32768, 9)
    data = text[: 2 * 32768] + rng.integers(0, 256, 32768, dtype=np.uint8).tobytes() + text[2 * 32768 :] + b"tail"
    cfg = TorchCodecConfig(engine="cuda", block_size=32768, batch_blocks=2, verify=True)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    timer = runtime.PhaseTimer()
    stream = runtime.compress(data, cfg, timer)
    assert timer.notes["raw_blocks"] == 1
    # 7 blocks on the device in batches of 2, 2, 2 and 1.
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == (launches[0] + 4, launches[1] + 4)
    plain = runtime.compress(data, TorchCodecConfig(engine="torch", device="cuda:0", block_size=32768))
    assert bytes(stream) == bytes(plain)
    assert bytes(runtime.decompress(bytes(stream), TorchCodecConfig(engine="cuda"))) == data
    assert oracle.decompress(bytes(stream)) == data


@pytest.mark.parametrize("preset", [None, "speed"])
def test_cuda_engine_compress_round_trip_64k(cuda_device, preset):
    from pim_compression_tpu_torch.utils.config import preset_overrides

    rng = np.random.default_rng(9)
    text = streams.text_payload(4 * 65536, 10)
    data = (
        text[:65536] + rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
        + streams.far_repeat_block(65536, 4) + text[65536:] + b"tail"
    )
    knobs = preset_overrides(preset, 65536) if preset else {}
    cfg = TorchCodecConfig(engine="cuda", block_size=65536, batch_blocks=2, verify=True, **knobs)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES
    timer = runtime.PhaseTimer()
    stream = runtime.compress(data, cfg, timer)
    assert timer.notes["raw_blocks"] == 1
    assert timer.notes.get("wide_select") == (None if preset else "sel_all sel_cap=16")
    # 6 blocks on the device in batches of 2.
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES) == (launches[0] + 3, launches[1] + 3)
    plain = runtime.compress(data, TorchCodecConfig(engine="torch", device="cuda:0", block_size=65536, **knobs))
    assert bytes(stream) == bytes(plain)
    assert bytes(runtime.decompress(bytes(stream), TorchCodecConfig(engine="cuda"))) == data
    assert oracle.decompress(bytes(stream)) == data


SWEEP = [
    (8192, dict(window=2048, coarse_window=8192, granular=True)),
    (8192, dict(window=2048, coarse_window=8192, granular=False)),
    (8192, dict(window=512, coarse_window=4096, granular=True)),
    (16384, dict(window=512, coarse_window=16384, granular=True)),
    (1024, dict(window=100, coarse_window=1000, granular=False)),
    (384, dict(window=64, coarse_window=0, granular=False)),
]


@pytest.mark.parametrize(
    "block_size, knobs", SWEEP,
    ids=["8192-w2048-granular", "8192-w2048-sampled", "8192-w512-granular", "16384-granular", "1024-sampled", "384-fine"],
)
def test_cuda_sweep_kernel_matches_plain_version(cuda_device, block_size, knobs):
    knobs = hopper_sweep.sweep_knobs(block_size, **knobs)  # as encode_knobs gives them
    n = 200 if block_size <= 1024 else 24
    rb, rl = streams.plain_blocks(block_size, n, block_size + 1)
    eb, el = streams.sweep_edge_blocks(block_size, knobs["window"], 2)
    text = np.frombuffer(streams.text_payload(8 * block_size, 6), np.uint8).reshape(8, block_size)
    blocks = torch.from_numpy(np.concatenate([rb, eb, text])).to(cuda_device)
    lens = torch.from_numpy(np.concatenate([rl, el, np.full(8, block_size, np.int32)])).to(cuda_device)
    launches = hopper_sweep.LAUNCHES
    mlen, mlag = hopper_sweep.sweep_match(blocks, lens, **knobs)
    torch.cuda.synchronize()
    assert hopper_sweep.LAUNCHES == launches + 1
    want_len, want_lag = hopper_sweep.sweep_match_torch(blocks, lens, **knobs)
    assert torch.equal(mlen, want_len) and torch.equal(mlag, want_lag)
    assert int(mlen.max()) == 64


@pytest.mark.parametrize("mode", ["sampled", "granular"])
def test_cuda_engine_sweep_round_trip(cuda_device, mode):
    rng = np.random.default_rng(12)
    text = streams.text_payload(5 * 8192, 13)
    data = text[:8192] + rng.integers(0, 256, 8192, dtype=np.uint8).tobytes() + text[8192:] + b"tail"
    knobs = dict(block_size=8192, matcher="sweep", match_window=2048, coarse_window=8192, coarse_mode=mode)
    cfg = TorchCodecConfig(engine="cuda", batch_blocks=2, verify=True, **knobs)
    launches = hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES, hopper_match.LAUNCHES
    timer = runtime.PhaseTimer()
    stream = runtime.compress(data, cfg, timer)
    assert timer.notes["raw_blocks"] == 1
    # 6 blocks on the device in batches of 2; the sorted matcher never runs.
    assert (hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES, hopper_match.LAUNCHES) == (
        launches[0] + 3, launches[1] + 3, launches[2]
    )
    plain = runtime.compress(data, TorchCodecConfig(engine="torch", device="cuda:0", **knobs))
    assert bytes(stream) == bytes(plain)
    assert bytes(runtime.decompress(bytes(stream), TorchCodecConfig(engine="cuda"))) == data
    assert oracle.decompress(bytes(stream)) == data


def test_cuda_sweep_wrapper_rejects_bad_tensors(cuda_device):
    blocks = torch.zeros((4, 512), dtype=torch.uint8, device=cuda_device)
    lens = torch.full((4,), 512, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        hopper_sweep.sweep_match(blocks[:, ::2], lens)
    with pytest.raises(ValueError):  # mixed devices
        hopper_sweep.sweep_match(blocks, lens.cpu())
    with pytest.raises(ValueError):  # past the sweep envelope
        hopper_sweep.sweep_match(torch.zeros((1, 32768), dtype=torch.uint8, device=cuda_device), lens[:1])


# The CLI on the GPU: its default engine is cuda.
CONFIG_A_FLAGS = ["--rungs", "full", "--prev-k", "4", "--sel-cap", "16", "--stride2-min", "16"]


@pytest.mark.parametrize("flags", [[], CONFIG_A_FLAGS], ids=["zero-flag", "config-a"])
def test_cuda_cli_round_trip(cuda_device, flags, tmp_path, capsys):
    from pim_compression_tpu_torch import cli

    data = streams.text_payload(5 * 32768 + 777, 21)
    src, comp, out = tmp_path / "in.txt", tmp_path / "c.snappy", tmp_path / "rt.txt"
    src.write_bytes(data)
    launches = hopper_match.LAUNCHES
    assert cli.main(["-c", "-b", "32768", "--json", *flags, "-i", str(src), "-o", str(comp)]) == 0
    assert hopper_match.LAUNCHES == launches + 1
    stdout = capsys.readouterr().out
    assert json.loads([line for line in stdout.splitlines() if line.startswith("{")][0])["engine"] == "cuda"
    cfg = cli._config(cli.build_parser().parse_args([*flags, "-i", "x"]), 32768, "torch")
    plain = runtime.compress(data, dataclasses.replace(cfg, device="cuda:0"))
    assert comp.read_bytes() == bytes(plain)
    assert cli.main(["-i", str(comp), "-o", str(out)]) == 0
    assert out.read_bytes() == data and oracle.decompress(comp.read_bytes()) == data


@pytest.mark.parametrize(
    "argv", [["-c"], ["-c", *CONFIG_A_FLAGS], ["-c", "-b", "65536", "--rungs", "4,32", "--rung-strides", "1,2",
                                               "--sort-window", "16384"], []],
    ids=["compress-zero-flag", "compress-config-a", "compress-64k-config-e", "decompress"],
)
def test_cuda_debug_dump_reports_no_mismatch(cuda_device, argv, tmp_path, monkeypatch, capsys):
    from pim_compression_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    data = streams.text_payload(3 * 65536, 23)
    src = tmp_path / "in.bin"
    src.write_bytes(data if "-c" in argv else _compress(data, 32768))
    assert cli.main([*argv, "--debug-block", "1", "-i", str(src)]) == 0
    assert "0 phases differ" in capsys.readouterr().out
    dump = np.load(tmp_path / "pim_debug_block.npz")
    phase = "match.len" if "-c" in argv else "decode.bytes"
    assert np.array_equal(dump[f"plain.{phase}"], dump[f"kernel.{phase}"]) and dump[f"plain.{phase}"].size


def test_cuda_cli_profile_traces_the_kernels(cuda_device, tmp_path):
    from pim_compression_tpu_torch import cli

    src, comp = tmp_path / "in.txt", tmp_path / "c.snappy"
    src.write_bytes(streams.text_payload(3 * 32768, 25))
    assert cli.main(["-c", "--profile", str(tmp_path / "prof"), "-i", str(src), "-o", str(comp)]) == 0
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert "match_blocks_kernel" in trace and "emit_blocks_kernel" in trace


def _probe_int32(rng, rows):
    x = rng.integers(-(2**31), 2**31, (rows, 128), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("steps", [1, 7, 40, 10_000])
@pytest.mark.parametrize("name", ["gather_chain", "ew_chain"])
def test_cuda_probe_chains_match_plain_versions(cuda_device, name, steps):
    from pim_compression_tpu_torch.ops import hopper_probes

    rng = np.random.default_rng(steps)
    x = _probe_int32(rng, 128)
    idx = torch.from_numpy(rng.integers(0, 128, (128, 128)).astype(np.int32))
    launches = hopper_probes.LAUNCHES[name]
    got = getattr(hopper_probes, name)(x.to(cuda_device), idx.to(cuda_device), steps)
    torch.cuda.synchronize()
    assert hopper_probes.LAUNCHES[name] == launches + 1
    want = getattr(hopper_probes, f"{name}_torch")(x, idx, steps)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("in_rows, out_rows", [(8, 8), (64, 8), (8, 64), (300, 300), (1, 4097)])
def test_cuda_probe_copy_matches_plain_version(cuda_device, in_rows, out_rows):
    from pim_compression_tpu_torch.ops import hopper_probes

    x = _probe_int32(np.random.default_rng(in_rows), in_rows)
    got = hopper_probes.copy_rows(x.to(cuda_device), out_rows)
    assert torch.equal(got.cpu(), hopper_probes.copy_rows_torch(x, out_rows))


@pytest.mark.parametrize("steps", [0, 1, 13, 100])
@pytest.mark.parametrize("rows", [8, 64, 4096])
def test_cuda_probe_mix_and_chain_match_plain_versions(cuda_device, rows, steps):
    from pim_compression_tpu_torch.ops import hopper_probes

    rng = np.random.default_rng(rows + steps)
    x, start = _probe_int32(rng, rows), _probe_int32(rng, 8)
    launches = dict(hopper_probes.LAUNCHES)
    got_mix = hopper_probes.mix_rounds(x.to(cuda_device), steps)
    got_chain = hopper_probes.chain_fold(start.to(cuda_device), rows, steps)
    torch.cuda.synchronize()
    assert hopper_probes.LAUNCHES["mix_rounds"] == launches["mix_rounds"] + 1
    assert hopper_probes.LAUNCHES["chain_fold"] == launches["chain_fold"] + 1
    assert torch.equal(got_mix.cpu(), hopper_probes.mix_rounds_torch(x, steps))
    assert torch.equal(got_chain.cpu(), hopper_probes.chain_fold_torch(start, rows, steps))


def test_cuda_probe_wrappers_reject_bad_tensors(cuda_device):
    from pim_compression_tpu_torch.ops import hopper_probes

    plane = torch.zeros((128, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        hopper_probes.gather_chain(plane.t(), plane, 1)
    with pytest.raises(ValueError):  # mixed devices
        hopper_probes.ew_chain(plane, plane.cpu(), 1)
    with pytest.raises(ValueError):  # not int32
        hopper_probes.copy_rows(plane.float(), 8)
    with pytest.raises(ValueError):  # rows not a multiple of 8
        hopper_probes.mix_rounds(plane[:12], 1)


def test_cuda_devbench_slope_measure(cuda_device):
    from pim_compression_tpu_torch.runtime import devbench

    bs = 1024
    plain = streams.text_payload(1024 * bs, 31)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES
    res = devbench.slope_measure(plain, TorchCodecConfig(engine="cuda", block_size=bs), iters=2)
    assert res["bs"] == bs and res["device"] == torch.cuda.get_device_name(cuda_device)
    keys = {"t_g1_s", "t_g8_s", "per_group_s", "device_gbps", "compile_s"}
    assert set(res["encode"]) == keys | {"ratio"} and set(res["decode"]) == keys
    calls = 2 * (1 + 2)  # G=1 and G=8: a first call and 2 timed each
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES) == (
        launches[0] + calls, launches[1] + calls, launches[2] + calls
    )
    blocks, lens = pipeline.blockize_plain(plain, bs)
    _, sizes = hopper_encode.encode_blocks_torch(
        torch.from_numpy(blocks).to(cuda_device), torch.from_numpy(lens).to(cuda_device),
        cap=pipeline.padded_capacity(bs), **hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs)),
    )
    assert res["encode"]["ratio"] == round(1 - float(sizes.sum()) / (1024 * bs), 4)
