"""Faults planted under the timed path, for the tests and ``controls.py``.

Each wraps a cell's entry (``kind`` "decompress" or "compress") and
returns a broken one, which the driver calls in the entry's place. A
sound comparison calls every one of these runs not correct.

- ``stale``: each call returns the previous call's answer (a step that
  returns its state unchanged);
- ``half``: only the first half of the batch is computed, the rest left
  zero (half of the batch left out);
- ``altered``: one byte of one block of each answer is flipped where it is
  produced (a token altered).

One chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import torch


def stale(kind: str, entry):
    held = []

    def call(*args, **kwargs):
        out = entry(*args, **kwargs)
        if not held:
            held.append(out)
            return out
        prev, held[0] = held[0], out
        return prev

    return call


def half(kind: str, entry):
    def call(rows, *args, **kwargs):
        keep = rows.shape[0] // 2
        cut = [a[:keep] if torch.is_tensor(a) and a.dim() and a.shape[0] == rows.shape[0] else a for a in args]
        first = entry(rows[:keep], *cut, **kwargs)
        outs = []
        for t in first:
            full = torch.zeros((rows.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
            full[:keep] = t
            outs.append(full)
        return tuple(outs)

    return call


def altered(kind: str, entry):
    count = [0]

    def call(*args, **kwargs):
        out = entry(*args, **kwargs)
        rows = out[0]
        k = count[0] % rows.shape[0]
        count[0] += 1
        rows[k, 0] ^= 1  # the first byte: a plaintext byte, or a stream's first tag
        return out

    return call


FAULTS = {"stale": stale, "half": half, "altered": altered}
