"""Device milliseconds a compress call spends in the match kernel's 64 KB
halves' lookup: the match kernel's device time in the traced window over
the window's calls, times the warps' cycles in the lookup (``clock64()`` by
each warp's lane 0 around it, in the traced kernel's second half of a rung
that sorts its 32 KB halves in turn) over the warps' cycles in all (the
CTA-cycles times the warps a CTA). Only block sizes above 32768 split a
rung, and there the kernel's CTA is 1024 threads, 32 warps."""

KERNEL = "match_blocks_kernel"
WARPS = 32  # a match CTA's warps at every block size that splits a rung


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    match = (kernel_summary() or {}).get("match")
    lookup = match.counters.get("lookup") if match is not None else None
    total = match.counters.get("total") if match is not None else None
    if run.entry != "compress" or not lookup or not total or run.trace is None or not run.calls:
        return None
    seconds = sum(s for name, s in run.trace.device_ops if KERNEL in name)
    return 1e3 * seconds / run.calls * lookup / (WARPS * total) if seconds > 0 else None
