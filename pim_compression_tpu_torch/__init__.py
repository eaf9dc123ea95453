"""pim_compression_tpu_torch — the block-parallel Snappy codec on PyTorch and CUDA.

A port of ``pim_compression_tpu`` (JAX/Pallas on a TPU) to PyTorch with
hand-written kernels for NVIDIA Hopper. It carries its own copies of the
reference's JAX-free modules (``format``, ``native``, ``utils.config``,
``utils.errors``) and imports neither JAX nor ``pim_compression_tpu``.
Compression and decompression run on the GPU; see ``runtime``.
"""

from pim_compression_tpu_torch import runtime  # noqa: F401
from pim_compression_tpu_torch.utils.config import TorchCodecConfig  # noqa: F401

__version__ = "0.1.0"
