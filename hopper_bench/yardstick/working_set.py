"""The working set of a cell, made from ``--seed``.

``base_bytes`` of text from the frozen generator, made from the traffic
file's fixed ``text_seed``, then as many copies of it as fill
``resident_bytes``: copy ``j`` is the base with every byte mapped through
``perms[j]``, a permutation of the 256 byte values drawn from ``--seed``,
one for each copy. A bijection on byte values keeps every repeat, so each
copy holds the same matches at the same places, and no two copies are
equal. The copies, laid end to end and cut into blocks of ``block_size``
bytes, ``batch_blocks`` a batch, are the batches the window drives, in an
order drawn from ``--seed``.

So every seed gives other bytes and nearly the same work: text made from
the run's own seed would move the work itself, by about a tenth of the
ratio from seed to seed (see ``PERF.md``). The port's matcher ranks words
by value, so its sizes move a little from one permutation to another; a
working set of hundreds of copies averages that out.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hopper_bench.yardstick.textgen import text_payload

MIB = 1 << 20


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use (``stream``) of the run's seed; any whole
    number serves as a seed, negative ones too."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


@dataclasses.dataclass(frozen=True)
class Layout:
    block_size: int
    batch_blocks: int
    resident_bytes: int
    base_bytes: int

    def __post_init__(self):
        base, batch = self.base_bytes, self.batch_bytes
        if self.resident_bytes % base or self.resident_bytes % batch:
            raise ValueError("the working set must hold whole copies of the base and whole batches")
        if max(base, batch) % min(base, batch):
            raise ValueError("a batch must hold whole copies of the base, or a copy whole batches")

    @property
    def batch_bytes(self) -> int:
        return self.block_size * self.batch_blocks

    @property
    def copies(self) -> int:
        return self.resident_bytes // self.base_bytes

    @property
    def batches(self) -> int:
        return self.resident_bytes // self.batch_bytes

    def pieces(self, b: int) -> list:
        """Batch ``b`` as [(copy, start, end)]: the byte ranges of the base,
        each mapped through its copy's permutation, laid end to end."""
        size = self.base_bytes
        if self.batch_bytes >= size:
            per = self.batch_bytes // size
            return [(b * per + j, 0, size) for j in range(per)]
        j, k = divmod(b, size // self.batch_bytes)
        return [(j, k * self.batch_bytes, (k + 1) * self.batch_bytes)]


def base_text(layout: Layout, text_seed: int) -> np.ndarray:
    """The base, uint8[base_bytes]."""
    return np.frombuffer(text_payload(layout.base_bytes, text_seed), dtype=np.uint8)


def permutations(layout: Layout, seed: int) -> np.ndarray:
    """uint8[copies, 256]: a permutation of the byte values for each copy."""
    table = np.tile(np.arange(256, dtype=np.uint8), (layout.copies, 1))
    return seed_rng(seed, 1).permuted(table, axis=1)


def batch_order(layout: Layout, seed: int) -> list:
    """The order in which the window drives the batches."""
    return [int(b) for b in seed_rng(seed, 2).permutation(layout.batches)]


def batch_plain(layout: Layout, base: np.ndarray, perms: np.ndarray, b: int) -> np.ndarray:
    """Batch ``b``'s plaintext, uint8[batch_blocks, block_size]."""
    rows = np.concatenate([perms[j][base[s:e]] for j, s, e in layout.pieces(b)])
    return rows.reshape(layout.batch_blocks, layout.block_size)
