"""Device placement for the port."""

from pim_compression_tpu_torch.parallel.device import resolve_device  # noqa: F401
