"""Device milliseconds a compress call spends in the match kernel's sort:
the match kernel's device time in the traced window over the window's
calls, times the sort's share of the kernel's CTA-cycles (the word build
and the radix passes, ``clock64()`` at the kernel's barriers in the traced
kernel)."""

KERNEL = "match_blocks_kernel"


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    match = (kernel_summary() or {}).get("match")
    share = match.share("sort", "total") if match is not None else None
    if run.entry != "compress" or share is None or run.trace is None or not run.calls:
        return None
    seconds = sum(s for name, s in run.trace.device_ops if KERNEL in name)
    return 1e3 * seconds / run.calls * share if seconds > 0 else None
