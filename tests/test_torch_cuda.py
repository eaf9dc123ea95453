"""The port's CUDA kernels (decode, match, sweep, emit, the probes), devbench and the staging ring, on a GPU.

Every test here needs a CUDA device and nvcc, carries the ``cuda`` marker
and skips without a device. The file imports no JAX, so it also runs where
only PyTorch is installed:

    python3 -m pytest tests/test_torch_cuda.py -q

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: the decode kernel by verdicts on every block and bytes on valid
blocks, the match and emit kernels exactly (every length, lag, size and
byte), the probe kernels exactly; and the engines against the plaintext,
at every pipeline depth, through pinned staging buffers.
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
from pim_compression_tpu_torch.utils.errors import SnappyError
from pim_compression_tpu_torch.ops import hopper_decode, hopper_encode, hopper_match, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline, staging
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


# 100, 1000 and 4097: outside the encoder's envelope, not multiples of 16
# (the kernel's byte-wise row writes); the plain version takes a few seconds
# a batch at these sizes.
@pytest.mark.parametrize("block_size", [100, 256, 1000, 4096, 4097, 24576, 65536])
def test_cuda_kernel_matches_plain_version(cuda_device, block_size):
    stream = _compress(streams.text_payload(6 * block_size + 99, block_size), block_size)
    base = [blk for blk in streams.hand_blocks(block_size) if blk[1] <= block_size] + _blocks(stream)
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


@pytest.mark.parametrize("block_size", [4096, 32768])
def test_cuda_plain_decode_graphs_equal_the_eager_loop(cuda_device, block_size, monkeypatch):
    # On CUDA tensors decode_blocks_torch replays its parse steps from a CUDA
    # graph kept for the batch's shape; with GRAPH_STEPS past every payload
    # it runs the eager loop, as on the CPU. Both give the same bytes and
    # error bits on every block. A second batch of the same shape replays the
    # kept graph on its own bytes and leaves the first batch's results alone.
    hand = streams.hand_blocks(block_size)
    blocks = hand + streams.block_mutants(hand, random.Random(block_size), 48, block_size)
    args = _on_device(blocks, block_size, cuda_device)
    assert int(args[1].max()) >= 4 * hopper_decode.GRAPH_STEPS  # the graph runs
    out_g, err_g = hopper_decode.decode_blocks_torch(*args, block_size)
    first = (out_g.clone(), err_g.clone())
    out_f, err_f = hopper_decode.decode_blocks_torch(*(t.flip(0).contiguous() for t in args), block_size)
    assert torch.equal(out_g, first[0]) and torch.equal(err_g, first[1])
    monkeypatch.setattr(hopper_decode, "GRAPH_STEPS", 1 << 30)
    out_e, err_e = hopper_decode.decode_blocks_torch(*args, block_size)
    assert err_g.dtype == torch.int32 and torch.equal(err_g, err_e)
    assert torch.equal(out_g, out_e)
    assert torch.equal(out_f, out_e.flip(0)) and torch.equal(err_f, err_e.flip(0))
    assert (err_e == 0).sum() >= len(hand)


def test_cuda_kernel_rejects_bad_tensors(cuda_device):
    comp = torch.zeros((4, 768), dtype=torch.uint8, device=cuda_device)
    lens = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        hopper_decode.decode_blocks(comp[:, ::2], lens, lens, block_size=256)
    with pytest.raises(ValueError):  # mixed devices
        hopper_decode.decode_blocks(comp, lens.cpu(), lens, block_size=256)
    # A cap far past the block (and one not a multiple of 16, so the window
    # is staged by byte loads): the kernel's shared memory does not depend
    # on the cap, so none is refused.
    blocks = streams.hand_blocks(32768)[:8]
    for cap in (200000, 200001):
        comp = torch.zeros((len(blocks), cap), dtype=torch.uint8)
        for i, (payload, _) in enumerate(blocks):
            comp[i, : len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        clen = torch.tensor([len(p) for p, _ in blocks], dtype=torch.int32)
        olen = torch.tensor([n for _, n in blocks], dtype=torch.int32)
        args = tuple(t.to(cuda_device) for t in (comp, clen, olen))
        out, err = hopper_decode.decode_blocks(*args, block_size=32768)
        want_out, want_err = hopper_decode.decode_blocks_torch(*args, 32768)
        assert not err.any() and torch.equal(err != 0, want_err != 0)
        assert torch.equal(out, want_out)


@pytest.mark.parametrize("block_size, blocks, n", [(1024, 3, 100), (4096, 2, 24)])
def test_cuda_engine_verdicts_on_fuzzed_streams(cuda_device, block_size, blocks, n):
    # The whole-stream mutants of test_fuzz_malformed (header-biased bit
    # flips, truncations, stomps, garbage tails): the cuda engine gives the
    # torch engine's verdict on each, and its bytes where both decode.
    from pim_compression_tpu_torch.utils.errors import SnappyError
    from test_fuzz_malformed import _mutants

    stream = _compress(streams.text_payload(blocks * block_size - block_size // 3, block_size), block_size)
    engines = {name: TorchCodecConfig(engine=name, device=dev, validate=True)
               for name, dev in (("cuda", "cuda:0"), ("torch", "cpu"))}
    launches = hopper_decode.LAUNCHES
    for m in _mutants(stream, random.Random(0xF2 + block_size), n):
        got = {}
        for name, cfg in engines.items():
            try:
                got[name] = bytes(runtime.decompress(m, cfg))
            except (SnappyError, ValueError, OverflowError):
                got[name] = None
        assert got["cuda"] == got["torch"]
    assert hopper_decode.LAUNCHES > launches


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
    hb, hl = streams.sweep_hard_blocks(block_size, knobs["window"], 3)  # the table walk's hard blocks
    text = np.frombuffer(streams.text_payload(8 * block_size, 6), np.uint8).reshape(8, block_size)
    blocks = torch.from_numpy(np.concatenate([rb, eb, hb, text])).to(cuda_device)
    lens = torch.from_numpy(np.concatenate([rl, el, hl, np.full(8, block_size, np.int32)])).to(cuda_device)
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


def test_cuda_sweep_residency(cuda_device):
    # Shared memory grows with the block size: two CTAs (blocks) an SM at
    # 8 KB, one at 16 KB, and the kernel's registers do not cut that.
    assert hopper_sweep.ctas_per_sm(8192, cuda_device) == 2
    assert hopper_sweep.ctas_per_sm(16384, cuda_device) == 1
    with pytest.raises(RuntimeError):
        hopper_sweep.ctas_per_sm(32768, cuda_device)


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


# Index planes: seeded in [0, 128); every column at one column (each
# gather load of a warp reads one word, a broadcast); every lane of a load
# at one bank, four distinct words of it (the 4-way conflict, the most a
# 128-word row allows); every index above 127, which the kernel reads as
# idx & 127 and the plain version takes masked. test_torch_probe_layout.py
# runs the kernels' CPU mirrors on the same planes.
CHAIN_INDEX = {
    "random": lambda rng: rng.integers(0, 128, (128, 128)),
    "one-column": lambda rng: np.full((128, 128), rng.integers(0, 128)),
    "one-bank": lambda rng: 32 * (np.arange(128)[None, :] % 4) + rng.integers(0, 32, (128, 1)),
    "above-127": lambda rng: rng.integers(128, 2**31, (128, 128), dtype=np.int64),
}
CHAIN_CASES = [(steps, "random") for steps in (1, 7, 40, 10_000)] + [
    (steps, index) for index in ("one-column", "one-bank", "above-127") for steps in (7, 10_000)
]


@pytest.mark.parametrize(
    "steps, index", CHAIN_CASES, ids=[f"{s}" if i == "random" else f"{s}-{i}" for s, i in CHAIN_CASES]
)
@pytest.mark.parametrize("name", ["gather_chain", "ew_chain"])
def test_cuda_probe_chains_match_plain_versions(cuda_device, name, steps, index):
    from pim_compression_tpu_torch.ops import hopper_probes

    rng = np.random.default_rng(steps)
    x = _probe_int32(rng, 128)
    idx = torch.from_numpy(CHAIN_INDEX[index](rng).astype(np.int32))
    launches = hopper_probes.LAUNCHES[name]
    got = getattr(hopper_probes, name)(x.to(cuda_device), idx.to(cuda_device), steps)
    torch.cuda.synchronize()
    assert hopper_probes.LAUNCHES[name] == launches + 1
    # The gather kernel reads idx & 127; the plain gather takes only [0, 128).
    want = getattr(hopper_probes, f"{name}_torch")(x, idx & 127 if name == "gather_chain" else idx, steps)
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


# ---------------------------------------------------------------------------
# The bounded-depth pipeline and its staging ring.
# ---------------------------------------------------------------------------


def _pipeline_payload() -> bytes:
    """12 blocks at 32 KB: block 3 random (diverted to a raw frame), a partial last block."""
    rng = np.random.default_rng(17)
    text = streams.text_payload(11 * 32768, 18)
    return text[: 3 * 32768] + rng.integers(0, 256, 32768, dtype=np.uint8).tobytes() + text[4 * 32768 :] + b"tail"


def test_cuda_pipeline_depths_agree(cuda_device):
    data = _pipeline_payload()
    got = {}
    for depth in (1, 2, 4):
        cfg = TorchCodecConfig(engine="cuda", block_size=32768, batch_blocks=2, pipeline_depth=depth)
        launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES
        stream = bytes(runtime.compress(data, cfg))
        assert bytes(runtime.decompress(stream, cfg)) == data
        # 11 device blocks and 12 blocks back: 6 batches of at most 2 each way.
        assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES) == (
            launches[0] + 6, launches[1] + 6, launches[2] + 6
        )
        got[depth] = stream
    assert got[1] == got[2] == got[4]
    plain = runtime.compress(data, TorchCodecConfig(engine="torch", device="cuda:0", block_size=32768))
    assert got[1] == bytes(plain)


def test_cuda_staging_is_pinned_and_reused(cuda_device, monkeypatch):
    monkeypatch.setattr(staging, "_POOL", {})
    data = _pipeline_payload()
    cfg = TorchCodecConfig(engine="cuda", block_size=32768, batch_blocks=2, pipeline_depth=4)
    stream = bytes(runtime.compress(data, cfg))
    runtime.decompress(stream, cfg)
    (ring,) = staging._POOL[str(cuda_device)]
    arenas = [a for slot in ring.slots for a in slot.arenas.values()]
    assert len(ring.slots) == 4 and len(arenas) == 8
    assert all(a.is_pinned() for a in arenas)
    ptrs = [a.data_ptr() for a in arenas]
    monkeypatch.setattr(staging, "_pinned_empty", lambda nbytes: pytest.fail("a new pinned allocation"))
    assert bytes(runtime.compress(data, cfg)) == stream  # the same sizes again: no new pinned memory
    assert bytes(runtime.decompress(stream, cfg)) == data
    assert staging._POOL[str(cuda_device)] == [ring]
    assert [a.data_ptr() for slot in ring.slots for a in slot.arenas.values()] == ptrs


@pytest.mark.parametrize("direction", ["decompress", "compress"])
def test_cuda_failed_pinned_allocation_raises(cuda_device, monkeypatch, direction):
    def fail(nbytes):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(staging, "_POOL", {})
    monkeypatch.setattr(staging, "_pinned_empty", fail)
    data = _pipeline_payload()
    stream = _compress(data, 32768)
    cfg = TorchCodecConfig(engine="cuda", block_size=32768, batch_blocks=2)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES
    with pytest.raises(SnappyError, match="pinned host staging"):
        if direction == "decompress":
            runtime.decompress(stream, cfg)
        else:
            runtime.compress(data, cfg)
    # Nothing ran on pageable memory instead.
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES) == launches


@pytest.mark.parametrize("direction", ["decompress", "compress"])
def test_cuda_drain_waits_for_its_batch(cuda_device, monkeypatch, direction):
    # The device made slow: every batch's kernels start behind a spin of
    # about 10 ms on the slot's stream, while the host runs ahead. A drain
    # that read its slot before the d2h copies had landed, or a slot
    # refilled while its copies were in flight, would give wrong bytes.
    module, name = (hopper_decode, "decode_blocks") if direction == "decompress" else (hopper_encode, "encode_blocks")
    entry = getattr(module, name)

    def slow(*args, **kw):
        torch.cuda._sleep(20_000_000)
        return entry(*args, **kw)

    data = _pipeline_payload()
    want = bytes(runtime.compress(data, TorchCodecConfig(engine="cuda", block_size=32768)))
    monkeypatch.setattr(module, name, slow)
    for depth in (2, 3):
        cfg = TorchCodecConfig(engine="cuda", block_size=32768, batch_blocks=1, pipeline_depth=depth)
        if direction == "decompress":
            assert bytes(runtime.decompress(want, cfg)) == data
        else:
            assert bytes(runtime.compress(data, cfg)) == want


def test_cuda_batches_overlap(cuda_device, monkeypatch):
    # From the slot streams' events: at depth 2 some batch's h2d and kernels
    # run before the batch ahead of it is back; at depth 1 none does.
    data = _pipeline_payload()
    stream = _compress(data, 32768)
    overlap = {}
    for depth in (1, 2):
        monkeypatch.setattr(staging, "TIMELINE", [])
        cfg = TorchCodecConfig(engine="cuda", block_size=32768, batch_blocks=1, pipeline_depth=depth)
        assert bytes(runtime.decompress(stream, cfg)) == data
        overlap[depth] = staging.overlap_ms(staging.TIMELINE)
        assert len(overlap[depth]) == 11
    assert max(overlap[1]) == 0 and max(overlap[2]) > 0


SWEEP_8K = dict(block_size=8192, matcher="sweep", match_window=2048, coarse_window=8192, coarse_mode="granular")
PORTABLE = dict(block_size=32768, engine="portable")


@pytest.mark.parametrize(
    "direction, knobs",
    [("decompress", dict(block_size=32768)), ("compress", dict(block_size=32768)), ("compress", SWEEP_8K),
     ("decompress", PORTABLE), ("compress", PORTABLE)],
    ids=["decompress", "compress", "compress-sweep", "decompress-portable", "compress-portable"],
)
def test_cuda_nothing_waits_between_launch_and_drain(cuda_device, monkeypatch, direction, knobs):
    # CUDA's sync debug mode raises on a call that waits for the device (an
    # item, a copy to pageable memory, a stream's synchronize; not
    # torch.cuda.synchronize, which the test refuses itself). It is on from
    # the moment a batch holds its slot until the next drain's wait: no
    # launch, kernel wrapper, verify or d2h enqueue at depth 2 may wait.
    _check_nothing_waits(monkeypatch, direction, knobs, None)


def _check_nothing_waits(monkeypatch, direction, knobs, devices):
    take, ready, synchronize = staging.Slot.take, staging.Slot.ready, torch.cuda.synchronize

    def strict_take(slot, batch):
        take(slot, batch)
        torch.cuda.set_sync_debug_mode("error")

    def drain_wait(slot):
        torch.cuda.set_sync_debug_mode("default")
        return ready(slot)

    def refused_synchronize(device=None):
        if torch.cuda.get_sync_debug_mode() != 0:
            raise RuntimeError("torch.cuda.synchronize between a launch and its drain")
        synchronize(device)

    data = _pipeline_payload()
    cfg = TorchCodecConfig(**{"engine": "cuda", **knobs}, batch_blocks=2, pipeline_depth=2, verify=True)
    stream = bytes(runtime.compress(data, cfg, _devices=devices))
    monkeypatch.setattr(staging.Slot, "take", strict_take)
    monkeypatch.setattr(staging.Slot, "ready", drain_wait)
    monkeypatch.setattr(torch.cuda, "synchronize", refused_synchronize)
    try:
        if direction == "decompress":
            assert bytes(runtime.decompress(stream, cfg, _devices=devices)) == data
        else:
            assert bytes(runtime.compress(data, cfg, _devices=devices)) == stream
    finally:
        torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# The block mesh, the processes and the dry run.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["decompress", "compress"])
def test_cuda_two_entries_on_one_card_never_wait(cuda_device, monkeypatch, direction):
    # Two mesh entries on one card: each batch of 4 blocks is two shards on
    # two rings of the same card, and still nothing waits between a launch
    # and its drain; the stream is the one-entry stream.
    data = _pipeline_payload()
    cfg = TorchCodecConfig(engine="cuda", block_size=32768, batch_blocks=2)
    want = bytes(runtime.compress(data, cfg))
    entries = [cuda_device, cuda_device]
    launches = hopper_match.LAUNCHES, hopper_decode.LAUNCHES
    assert bytes(runtime.compress(data, cfg, _devices=entries)) == want
    assert bytes(runtime.decompress(want, cfg, _devices=entries)) == data
    # 11 device blocks and 12 blocks back, in batches of 2 per entry: 6 shards each way.
    assert (hopper_match.LAUNCHES, hopper_decode.LAUNCHES) == (launches[0] + 6, launches[1] + 6)
    _check_nothing_waits(monkeypatch, direction, dict(block_size=32768), entries)


def test_cuda_mesh_splits_over_two_cards(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    data = _pipeline_payload()
    one = TorchCodecConfig(engine="cuda", block_size=32768, mesh_devices=1)
    two = dataclasses.replace(one, mesh_devices=2)
    want = bytes(runtime.compress(data, one))
    torch.cuda.set_device(0)
    launches = hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES
    assert bytes(runtime.compress(data, two)) == want
    assert bytes(runtime.decompress(want, two)) == data
    # One batch each way, two shards: each kernel launched twice, once on
    # each card; the bindings' cudaSetDevice left the current device as it was.
    assert (hopper_match.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES) == tuple(n + 2 for n in launches)
    assert torch.cuda.current_device() == 0
    assert staging._POOL.get("cuda:1"), "the second card's ring went back to the pool"
    assert bytes(runtime.decompress(want, dataclasses.replace(two, pipeline_depth=1, batch_blocks=1))) == data


def test_cuda_two_processes_on_the_card(cuda_device, tmp_path):
    from pim_compression_tpu_torch.scripts import multiproc_worker

    data = _pipeline_payload()
    src, out, dec = tmp_path / "in.bin", tmp_path / "out.snappy", tmp_path / "dec.bin"
    src.write_bytes(data)
    records = multiproc_worker.run_ranks(2, src, out, dec, 32768, "cuda", timeout=240)
    assert out.read_bytes() == bytes(runtime.compress(data, TorchCodecConfig(engine="cuda", block_size=32768)))
    assert dec.read_bytes() == data
    assert [tuple(r["process_blocks"]) for r in records] == [(0, 6), (6, 12)]
    assert all(r["launches"]["match"] == r["launches"]["emit"] == r["launches"]["decode"] == 1 for r in records)


def test_cuda_dryrun_multichip(cuda_device, capsys):
    from pim_compression_tpu_torch.parallel import dryrun

    records = dryrun.dryrun_multichip(2)
    assert [r["launches"] for r in records] == [{"match": 2, "emit": 2, "decode": 2}] * 3
    assert records[0]["compressed"] == records[1]["compressed"] == 7747
    assert capsys.readouterr().out.count("dryrun_multichip OK") == 3


def test_cuda_entry_equals_the_cpu_entry(cuda_device):
    # The entry point on the card launches the decode kernel once and
    # gives the plain version's bytes on the CPU, with no error bit.
    from pim_compression_tpu_torch.parallel import dryrun

    fn, args = dryrun.entry()
    assert all(t.device.type == "cuda" for t in args)
    launches = hopper_decode.LAUNCHES
    out, err = fn(*args)
    assert hopper_decode.LAUNCHES == launches + 1
    cpu_fn, cpu_args = dryrun.entry(device="cpu")
    want, want_err = cpu_fn(*cpu_args)
    assert torch.equal(out.cpu(), want) and not err.any() and not want_err.any()


# ---------------------------------------------------------------------------
# The portable engine (plain PyTorch ops, no hand kernel) and the fallback.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_size", [100, 1024, 32768, 65536])
def test_cuda_portable_functions_equal_the_cpu(cuda_device, block_size):
    from pim_compression_tpu_torch.ops import decode as decode_ops, encode as encode_ops

    blocks, lens = streams.plain_blocks(block_size, 8, block_size)
    cpu = (torch.from_numpy(blocks), torch.from_numpy(lens))
    gpu = tuple(t.to(cuda_device) for t in cpu)
    comp_c, sizes_c = encode_ops.encode_blocks(*cpu, block_size=block_size)
    comp_g, sizes_g = encode_ops.encode_blocks(*gpu, block_size=block_size)
    assert torch.equal(comp_g.cpu(), comp_c) and torch.equal(sizes_g.cpu(), sizes_c)
    base = _blocks(_compress(streams.text_payload(4 * block_size, 2), block_size))
    if block_size >= 256:
        base += streams.hand_blocks(block_size)
    args = _on_device(base + streams.block_mutants(base, random.Random(block_size), 48, block_size), block_size,
                      cuda_device)
    out_g, err_g = decode_ops.decode_blocks(*args, block_size=block_size)
    out_c, err_c = decode_ops.decode_blocks(*(a.cpu() for a in args), block_size=block_size)
    assert torch.equal(out_g.cpu(), out_c) and torch.equal(err_g.cpu(), err_c)
    assert not err_c[: len(base)].any()


def test_cuda_portable_engine_equals_the_cpu(cuda_device):
    data = _pipeline_payload()
    launches = hopper_match.LAUNCHES, hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES
    cfg = TorchCodecConfig(engine="portable", block_size=32768, batch_blocks=2, verify=True)
    timer = runtime.PhaseTimer()
    stream = bytes(runtime.compress(data, cfg, timer))
    assert timer.notes == {"raw_blocks": 1}
    assert stream == bytes(runtime.compress(data, dataclasses.replace(cfg, device="cpu")))
    assert bytes(runtime.decompress(stream, cfg)) == data == oracle.decompress(stream)
    assert (hopper_match.LAUNCHES, hopper_sweep.LAUNCHES, hopper_encode.LAUNCHES, hopper_decode.LAUNCHES) == launches


@pytest.mark.parametrize("knobs", [dict(block_size=32768, matcher="sweep"), dict(block_size=128)],
                         ids=["sweep-32768", "bs-128"])
def test_cuda_engine_falls_back_to_portable(cuda_device, knobs):
    data = _pipeline_payload()[: 1 << 20]
    want = bytes(runtime.compress(data, TorchCodecConfig(engine="portable", block_size=knobs["block_size"])))
    mods = (hopper_match, hopper_sweep, hopper_encode, hopper_decode)
    launches = [m.LAUNCHES for m in mods]
    timer = runtime.PhaseTimer()
    with pytest.warns(UserWarning, match="falling back to the portable engine"):
        assert bytes(runtime.compress(data, TorchCodecConfig(engine="cuda", **knobs), timer)) == want
    assert timer.notes["engine_fallback"].startswith("cuda->portable (")
    with pytest.raises(SnappyError) as e:
        runtime.compress(data, TorchCodecConfig(engine="cuda", strict_engine=True, **knobs))
    assert "falling back" in str(e.value)
    assert [m.LAUNCHES for m in mods] == launches


# ---------------------------------------------------------------------------
# The measurement tools.
# ---------------------------------------------------------------------------


def test_cuda_kernel_attrib_parts_add_to_the_whole(cuda_device):
    from pim_compression_tpu_torch.scripts import kernel_attrib

    res = kernel_attrib.run(cuda_device, names=["32768 zero-flag", "8192 sweep"], decode_sizes=(32768,), fixed=False)
    assert [r["config"] for r in res["records"]] == ["32768 decode", "32768 zero-flag", "8192 sweep"]
    for r in res["records"]:
        assert abs(r["sum_over_whole"] - 1) <= 0.05, r
        kernels = {"32768 decode": ["decode"], "32768 zero-flag": ["match", "emit"], "8192 sweep": ["sweep", "emit"]}
        assert list(r["bounds"]) == kernels[r["config"]]
        assert all(0 < b["share"] <= 1 for b in r["bounds"].values())


def test_cuda_validate_config_a(cuda_device):
    from pim_compression_tpu_torch.scripts import validate

    res = validate.run(validate.parse(["--bs", "32768", "--matcher", "sorted", "--prev-k", "4", "--sel-cap", "16",
                                       "--stride2-min", "16", "--ext-cap", "48", "--neighbor", "--max-lag", "8192",
                                       "--quick", "--device", str(cuda_device)]))
    assert res["kernels"] and res["engine"] == "cuda"
    assert (res["decode_max_abs_err"], res["match_max_abs_err"], res["emit_max_abs_err"]) == (0, 0, 0)
    assert res["decode_bit_exact"] and res["encode_round_trip"] and res["encode_decodes_ok"]
