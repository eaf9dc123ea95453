"""The benchmark's plain reference of the sweep configurations' encode.

``hopper_bench/yardstick/sweep_ref.py`` decides the ``bs8k_sweep`` cell's
exact comparison on the card. Here it is held, byte for byte, to the port's
normal entry (``hopper_encode.encode_blocks`` with ``matcher="sweep"`` on
CPU tensors, the plain PyTorch matcher and emit) at 1 KB and 8 KB blocks,
with and without a coarse search, on text, repetitive, all-zero and
incompressible blocks; and it imports neither JAX, the JAX package nor the
port. This file imports none of them either; the comparison with the JAX
package's NumPy spec is ``test_torch_sweep_reference_spec.py``.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from hopper_bench.core import cells
from hopper_bench.yardstick import sweep_ref
from pim_compression_tpu_torch.ops import hopper_encode, hopper_sweep
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

# (block_size, match_window, coarse_window, coarse_mode): the cell's 2048 /
# 8192 granular at 8 KB, a window alone at 8 KB and 1 KB, and sampled and
# granular reaches at 1 KB (100 rounds up to 128; 1000 cuts to whole chunks).
KNOBS = [
    (8192, 2048, 8192, "granular"),
    (8192, 512, 0, "sampled"),
    (1024, 256, 0, "sampled"),
    (1024, 100, 1000, "sampled"),
    (1024, 64, 1024, "granular"),
]
KNOB_IDS = ["8192-w2048-granular", "8192-w512", "1024-w256", "1024-w100-sampled", "1024-w64-granular"]


def _blocks(kind: str, block_size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(blocks uint8[n, bs], lens int32[n]), zero past each length: seeded
    text, one full and one cut short; repetitive data (a short phrase
    repeated, and a byte run); all zeros; incompressible random bytes."""
    rng = np.random.default_rng(seed)
    bs = block_size
    if kind == "text":
        rows = np.frombuffer(streams.text_payload(2 * bs, seed), np.uint8).reshape(2, bs).copy()
        lens = np.array([bs, bs - 77], np.int32)
    elif kind == "repetitive":
        phrase = rng.integers(97, 123, 37, dtype=np.uint8)
        rows = np.stack([np.resize(phrase, bs), np.full(bs, 7, np.uint8)])
        lens = np.array([bs, bs - 3], np.int32)
    elif kind == "zeros":
        rows = np.zeros((1, bs), np.uint8)
        lens = np.array([bs], np.int32)
    else:
        rows = rng.integers(0, 256, (1, bs), dtype=np.uint8)
        lens = np.array([bs], np.int32)
    rows[np.arange(bs)[None, :] >= lens[:, None]] = 0
    return rows, lens


def _ref(blocks: np.ndarray, lens: np.ndarray, block_size: int, window: int, coarse: int, mode: str) -> list:
    w, c = sweep_ref.knobs(block_size, window, coarse, mode == "granular")
    return [sweep_ref.encode_block(blocks[i, : lens[i]].tobytes(), block_size, w, c, mode == "granular")
            for i in range(len(lens))]


@pytest.mark.parametrize("kind", ["text", "repetitive", "zeros", "random"])
@pytest.mark.parametrize("block_size, window, coarse, mode", KNOBS, ids=KNOB_IDS)
def test_reference_equals_the_port_entry(block_size, window, coarse, mode, kind):
    blocks, lens = _blocks(kind, block_size, 11 + block_size + window)
    cap = pipeline.padded_capacity(block_size)
    knobs = hopper_sweep.sweep_knobs(block_size, window, coarse, mode == "granular")
    assert sweep_ref.knobs(block_size, window, coarse, mode == "granular") == (knobs["window"],
                                                                              knobs["coarse_window"])
    comp, sizes = hopper_encode.encode_blocks(torch.from_numpy(blocks), torch.from_numpy(lens), cap=cap,
                                              matcher="sweep", **knobs)
    port = [comp[i, : int(sizes[i])].numpy().tobytes() for i in range(len(lens))]
    assert _ref(blocks, lens, block_size, window, coarse, mode) == port


def test_knobs_follow_the_reference_rule():
    assert sweep_ref.knobs(8192, 2048, 8192, True) == (2048, 8192)
    assert sweep_ref.knobs(8192, 2048, 8000, False) == (2048, 7936)  # whole 256-lag chunks
    assert sweep_ref.knobs(1024, 100, 0) == (128, 0) and sweep_ref.knobs(1024, 2048, 8192, True) == (1024, 0)
    for bad in ((32768, 512, 0, False), (8192, -1, 0, False), (8000, 512, 8000, True)):
        with pytest.raises(ValueError):
            sweep_ref.knobs(*bad)


def test_reference_imports_no_jax_nor_the_port():
    # Whole top-level names: the port's name begins with the JAX package's.
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from hopper_bench.yardstick import sweep_ref\n"
        "sweep_ref.encode_block(b'abcdabcdabcd' * 40, 1024, 256, 1024, True)\n"
        "bad = {'jax', 'jaxlib', 'pim_compression_tpu', 'pim_compression_tpu_torch'}\n"
        "print(','.join(sorted({m.split('.')[0] for m in sys.modules} & bad)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(cells.CHECKOUT)], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == ""
