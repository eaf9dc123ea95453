"""Host milliseconds inside the compress entry, the mean over the window's
calls, from the benchmark's own span around each call (checks,
allocations, the ctypes launches). It sets the pace only once it is longer
than a batch's device time."""


def read(run):
    if run.entry != "compress" or not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
