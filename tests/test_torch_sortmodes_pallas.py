"""The sorted matcher's sort modes and ladders in the port, against the JAX
package's Pallas kernels in interpret mode and its runtime.

The cases of ``test_torch_sortmodes.py`` that run the JAX package's Pallas
kernels (each interpret-mode call takes seconds, so they sit in a file of
their own, which the test runner's workers take apart from the rest): the
interpret-mode ``encode_blocks_pallas`` and the JAX
``runtime.compress(engine="pallas")`` stream, exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pim_compression_tpu.format import oracle
from pim_compression_tpu.utils.config import CodecConfig
from pim_compression_tpu_torch import TorchCodecConfig, runtime
from pim_compression_tpu_torch.ops import hopper_encode
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams
from test_torch_sortmodes import _inputs, _spec_knobs

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)


# The interpret-mode Pallas kernels: one 128-block group at bs 1024 each,
# the cases known to run there (tests/test_pallas_encode.py:548-570 with
# the cheap select added, and :866's windowed rung pick).
PALLAS_CASES = {
    "ladder-strided-sel16": dict(rungs=(4, 16, 64), prev_k=2, stride2_min=16, sel_cap=16),
    "rung-pick-window-512": dict(rungs=(4, 16), sort_window=512),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_torch_encode_sort_modes_match_pallas_interpret(case):
    import jax.numpy as jnp

    from pim_compression_tpu.ops import pallas_encode

    bs = 1024
    cfg = TorchCodecConfig(engine="torch", block_size=bs, **PALLAS_CASES[case])
    blocks, lens = _inputs(bs, 77 + len(case), pallas_encode.LANES - 9)
    spec = _spec_knobs(cfg)
    comp_k, sizes_k = pallas_encode.encode_blocks_pallas(
        jnp.asarray(blocks), jnp.asarray(lens), block_size=bs, matcher="sorted", interpret=True, **spec
    )
    comp, sizes = hopper_encode.encode_blocks(
        torch.from_numpy(blocks), torch.from_numpy(lens), cap=pipeline.padded_capacity(bs),
        **hopper_encode.encode_knobs(cfg),
    )
    sizes_k = np.asarray(sizes_k)
    np.testing.assert_array_equal(sizes.numpy(), sizes_k)
    comp_k = np.asarray(comp_k)
    for i, n in enumerate(sizes_k):
        assert comp[i, :n].numpy().tobytes() == comp_k[i, :n].tobytes(), f"block {i}"


def test_torch_compress_ladder_prev6_equals_jax_pallas_stream():
    # Config (b), the CLI's "ratio champion" ladder: the whole stream of the
    # JAX runtime on its pallas engine (interpret mode here).
    from pim_compression_tpu import runtime as ref_runtime

    knobs = dict(rungs=(4, 16), rung_pick=False, prev_k=6)
    data = streams.text_payload(12 * 1024 + 300, 5)
    want = ref_runtime.compress(data, CodecConfig(engine="pallas", block_size=1024, **knobs))
    got = runtime.compress(data, TorchCodecConfig(engine="torch", block_size=1024, **knobs))
    assert bytes(got) == bytes(want)
    assert oracle.decompress(bytes(got)) == data
