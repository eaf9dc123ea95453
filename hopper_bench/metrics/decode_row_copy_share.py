"""The share of the bytes the decode kernel's valid copy elements copied in
the traced window that it read from the block's row in device memory (L2),
past its 16 KB history ring, in %, from the traced kernel's counters. 0
where no copy reaches past the ring, as a lag cap below 16 KB ensures."""


def read(run):
    try:
        from pim_compression_tpu_torch.runtime.profiling import kernel_summary
    except ImportError:  # a program without kernel spans
        return None
    decode = (kernel_summary() or {}).get("decode")
    share = decode.share("from_row", "copied") if decode is not None else None
    if run.entry != "decompress" or share is None:
        return None
    return 100.0 * share
