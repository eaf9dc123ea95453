"""Wire-format core: constants, varints, framing, and the oracle codec
(the port's own copy of ``pim_compression_tpu.format``)."""

from pim_compression_tpu_torch.format import constants, oracle, varint  # noqa: F401
