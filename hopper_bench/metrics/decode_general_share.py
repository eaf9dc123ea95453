"""The share of the elements the decode kernel walked in the traced window
that left its short paths for the general one (the error bits, a window
refill, a ring flush or ``copy_slow``), in %, from the traced kernel's
counters."""


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    decode = (kernel_summary() or {}).get("decode")
    share = decode.share("general", "elements") if decode is not None else None
    if run.entry != "decompress" or share is None:
        return None
    return 100.0 * share
