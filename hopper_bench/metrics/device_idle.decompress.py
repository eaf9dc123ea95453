"""The share of the traced window, in %, in which no kernel, copy or fill
ran on the card, while the decompress entry was driven."""


def read(run):
    if run.entry != "decompress" or run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
