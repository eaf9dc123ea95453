"""Table entries the sweep kernel visits a position, over the traced
window's sweep launches: the entries its lanes visited and those its
warps' rounds visited (32 a round), over the positions it walked (those
with 4 bytes left), from the traced kernel's counters (``csrc/sweep.cu``).
An exhaustive sweep of the cell's lags visits about 2,080 a position."""


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    sweep = (kernel_summary() or {}).get("sweep")
    if run.entry != "compress" or sweep is None:
        return None
    c = sweep.counters
    return (c["lane_entries"] + c["round_entries"]) / c["positions"] if c["positions"] else None
