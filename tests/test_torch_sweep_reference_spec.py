"""The benchmark's plain reference of the sweep encode against the JAX package's NumPy spec.

``hopper_bench/yardstick/sweep_ref.py`` is written from the encoder's
published rules and imports no JAX; here its streams are held, byte for
byte, to ``lane_model_encode`` (``encode_lanes`` for the sampled sweep,
``match_search_granular`` through the spec's lazy-1, parse and layout for
the granular one) on text, the sweep's edge blocks and its hard blocks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hopper_bench.yardstick import sweep_ref
from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)


def _spec(blocks: np.ndarray, lens: np.ndarray, window: int, coarse: int, mode: str, cap: int) -> list:
    """The JAX package's NumPy spec of the sweep encode: ``encode_lanes``
    (its sweep is the sampled one), or the granular search through the
    spec's lazy-1, parse and layout."""
    if mode == "sampled":
        comp, sizes = lme.encode_lanes(blocks, lens, blocks.shape[1], cap, window=window, coarse_window=coarse)
        return [comp[i, : sizes[i]].tobytes() for i in range(len(lens))]
    data = blocks.T.astype(np.int32)
    best_len, best_off = lme.match_search_granular(data, lens, window, coarse)
    best_len = lme.lazy_defer(best_len)
    accept, is_copy = lme.greedy_parse(best_len, lens)
    comp, sizes = lme.layout_and_emit(data, lens, accept, is_copy, best_len, best_off, cap)
    return [comp[: sizes[i], i].tobytes() for i in range(len(lens))]


@pytest.mark.parametrize("block_size, window, coarse, mode",
                         [(8192, 2048, 8192, "granular"), (2048, 64, 1500, "granular"), (2048, 100, 1088, "sampled"),
                          (1024, 32, 0, "sampled")],
                         ids=["8192-w2048-granular", "2048-w64-granular", "2048-w100-sampled", "1024-w32"])
def test_reference_equals_the_spec(block_size, window, coarse, mode):
    w, c = sweep_ref.knobs(block_size, window, coarse, mode == "granular")
    text = np.frombuffer(streams.text_payload(2 * block_size, 5), np.uint8).reshape(2, block_size).copy()
    text_lens = np.array([block_size, block_size - 77], np.int32)
    edge, edge_lens = streams.sweep_edge_blocks(block_size, w, 6)
    hard, hard_lens = streams.sweep_hard_blocks(block_size, w, 7)
    if block_size > 2048:  # the spec's search is slow at 8 KB: the text and one of each kind
        edge, edge_lens, hard, hard_lens = edge[:1], edge_lens[:1], hard[:2], hard_lens[:2]
    blocks = np.concatenate([text, edge, hard])
    lens = np.concatenate([text_lens, edge_lens, hard_lens]).astype(np.int32)
    blocks[np.arange(block_size)[None, :] >= lens[:, None]] = 0
    want = _spec(blocks, lens, w, c, mode, pipeline.padded_capacity(block_size))
    got = [sweep_ref.encode_block(blocks[i, : lens[i]].tobytes(), block_size, w, c, mode == "granular")
           for i in range(len(lens))]
    assert got == want
