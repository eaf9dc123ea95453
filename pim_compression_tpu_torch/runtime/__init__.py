"""Host-side runtime of the port: frame scan, blockize, device dispatch, profiling."""

from pim_compression_tpu_torch.runtime.api import compress, decompress  # noqa: F401
from pim_compression_tpu_torch.runtime.profiling import PhaseTimer  # noqa: F401
