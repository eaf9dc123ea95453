"""Device milliseconds a compress call spends in the sweep kernel's walk:
the sweep kernel's device time in the traced window over the window's
calls, times the walk's share (the lanes' walk and the warps' rounds) of
the kernel's CTA-cycles (``clock64()`` at the kernel's barriers in the
traced kernel, ``csrc/sweep.cu``)."""

KERNEL = "sweep_blocks_kernel"


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    sweep = (kernel_summary() or {}).get("sweep")
    if run.entry != "compress" or sweep is None or run.trace is None or not run.calls:
        return None
    lanes, rounds = sweep.share("lanes", "total"), sweep.share("rounds", "total")
    if lanes is None:
        return None
    seconds = sum(s for name, s in run.trace.device_ops if KERNEL in name)
    return 1e3 * seconds / run.calls * (lanes + rounds) if seconds > 0 else None
