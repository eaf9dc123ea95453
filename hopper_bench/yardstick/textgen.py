"""Frozen copy of ``pim_compression_tpu_torch.utils.streams.text_payload``.

Copied byte for byte from commit 71cf44af88e2ee9ebbcc411566b7e4a08f8328ee,
so that a later change to the program's generator cannot change the text every
cell is measured on. Do not edit it: a different generator is a new file.
"""

from __future__ import annotations

import numpy as np


def text_payload(n: int, seed: int = 0) -> bytes:
    """``n`` bytes of text-like data: Zipf-distributed words from a seeded
    vocabulary, with near repeats (lag <= 4 KB), far repeats, byte runs and
    a few stretches of random bytes."""
    rng = np.random.default_rng(seed)
    vocab = 4096
    wlen = rng.integers(2, 12, vocab)
    woff = np.concatenate([[0], np.cumsum(wlen)])
    letters = rng.integers(97, 123, int(woff[-1]), dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    pos = 0
    while pos < n:
        m = min(int(rng.integers(256, 8192)), n - pos)
        r = rng.random()
        if r < 0.12 and pos >= 64:  # near repeat, possibly overlapping
            lag = int(rng.integers(1, min(pos, 4096) + 1))
            out[pos : pos + m] = np.resize(out[pos - lag : pos], m)
        elif r < 0.22 and pos >= m:  # far repeat
            src = int(rng.integers(0, pos - m + 1))
            out[pos : pos + m] = out[src : src + m]
        elif r < 0.27:  # byte runs
            run_len = rng.integers(1, 200, m // 8 + 1)
            out[pos : pos + m] = np.repeat(rng.integers(0, 256, run_len.size, dtype=np.uint8), run_len)[:m]
        elif r < 0.29:  # incompressible stretch
            out[pos : pos + m] = rng.integers(0, 256, m, dtype=np.uint8)
        else:  # words
            ids = (rng.zipf(1.3, m // 3 + 1) - 1) % vocab
            lens = wlen[ids] + 1  # word + separator
            ends = np.cumsum(lens)
            within = np.arange(int(ends[-1])) - np.repeat(ends - lens, lens)
            idx = np.repeat(woff[ids], lens) + within
            words = letters[np.minimum(idx, woff[-1] - 1)]  # a separator slot may index past the end
            words[ends - 1] = 32
            out[pos : pos + m] = np.resize(words, m)
        pos += m
    return out.tobytes()
