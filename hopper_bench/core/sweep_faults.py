"""A fault of ``faults.py``'s kind for the sweep matcher's configurations.

- ``narrow``: the compress entry searches half the configuration's fine
  window. Every stream still decodes to its plaintext, so ``bad_blocks``
  stays 0; it is not the configuration's stream, which the exact
  comparison (``drivers/device_batches_exact.py``) finds.
"""

from __future__ import annotations

import functools


def narrow(kind: str, entry):
    knobs = getattr(entry, "keywords", {})
    if kind != "compress" or knobs.get("matcher") != "sweep":
        raise ValueError("narrow takes the sweep matcher's compress entry")
    return functools.partial(entry.func, *entry.args, **dict(knobs, window=knobs["window"] // 2))


FAULTS = {"narrow": narrow}
