"""How close the emit kernel's mean walk comes to its slowest, in %, as
``decode_walk_balance`` reads it for the decode: the walks' durations
summed over the traced window's emit launches, over each launch's walks
times its span from earliest start to latest end, summed (``%globaltimer``
in the traced kernel; a walk is one warp's block)."""


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    emit = (kernel_summary() or {}).get("emit")
    if run.entry != "compress" or emit is None or emit.walk_balance is None:
        return None
    return 100.0 * emit.walk_balance
