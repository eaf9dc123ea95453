"""The decode's share of its roofline, in %: the least time the card needs
to move the bytes the window's decode calls must move (``yardstick/work.py``:
compressed bytes read, plaintext written, once each, at 3.35 TB/s) over the
device time of what the entry launched in the traced window."""

from hopper_bench.yardstick import work


def read(run):
    if run.entry != "decompress" or run.trace is None:
        return None
    return work.roofline_percent(run.function_bytes, run.trace.device_s)
