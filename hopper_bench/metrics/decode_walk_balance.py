"""How close the decode kernel's mean walk comes to its slowest, in %: the
walks' durations summed over the traced window's decode launches, over each
launch's walks times the span from its earliest walk start to its latest
walk end, summed (``%globaltimer`` in the traced kernel; a walk is one
warp's block, from its first header read to its last store). 100 where
every walk of a launch lasts as long as the launch."""


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    decode = (kernel_summary() or {}).get("decode")
    if run.entry != "decompress" or decode is None or decode.walk_balance is None:
        return None
    return 100.0 * decode.walk_balance
