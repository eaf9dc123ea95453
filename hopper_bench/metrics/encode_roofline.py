"""The encode's share of its roofline, in %: the least time the card needs
to move the bytes the window's encode calls must move (``yardstick/work.py``:
plaintext read, compressed bytes written, once each, at 3.35 TB/s) over the
device time of what the entry launched (match and emit) in the traced
window."""

from hopper_bench.yardstick import work


def read(run):
    if run.entry != "compress" or run.trace is None:
        return None
    return work.roofline_percent(run.function_bytes, run.trace.device_s)
