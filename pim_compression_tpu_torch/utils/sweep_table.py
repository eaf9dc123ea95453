"""A NumPy model of the sweep kernel's table walk (``csrc/sweep.cu``), step by step.

The kernel gives every position p of a block the longest bucketed byte run
at the nearest lag, as ``hopper_sweep.sweep_match_torch`` does, but visits
only the earlier positions whose first 4-byte word equals p's. This module
follows its steps array by array, so that a fault of the design shows on a
CPU, and counts the steps, so that the timing script can report them:

- the words ``W[p]`` (bytes p..p+3, little-endian, zero at and past the
  block's length) and a key: the top ``kPasses * kDigitBits`` bits of
  ``W[p] * kHashMul`` (mod 2^32), or all ones where ``p + 4 > len``;
- the rank: a stable LSD radix sort of ``(key << kPosBits) | p`` over the
  key field in 6-bit digits, each warp of the CTA owning a contiguous slice:
  per pass the digit counts of every slice, one scan in digit-major,
  warp-minor order, and each word to its digit's offset plus the number of
  earlier words of its digit in its slice. Equal keys then lie together in
  ascending p, so walking down from p's own rank visits the earlier
  positions with p's key nearest first;
- the walk of position p: entries below its rank while the key is p's and
  the lag ``d = p - q`` is within its reach (``window``, or ``coarse`` where
  a coarse search runs for p: every position when sampled, the 8-aligned
  ones with 8 bytes left when granular), that is while an entry is at
  least ``(key << kPosBits) | max(p - reach, 0)``. Past the window a sampled lag
  counts only when ``d % 8 == 0`` and a granular run only from 2 words on.
  A key collision (``W[q] != W[p]``) is skipped. An entry that passes is
  measured: one compare of the last word a run needs to beat the best so
  far, then the run in words (at most 16 and the words left before the
  length), bucketed; a longer bucket replaces the best. The walk ends once
  the bucket is the longest the remaining length allows (``top``);
- the budget: a lane walks at most ``kBudget`` entries. A position still
  open then goes to its warp, which walks the rest 32 entries a round, one
  a lane, each lane's reject against the best at the round's start, and
  folds the packed candidates ``(len << 16) | (0xFFFF - d)`` by their
  maximum; the position ends after the round in which an entry left the
  chain or the reach, or the best reached ``top``.

``sweep_table`` returns the kernel's ``(mlen, mlag)`` and adds its counts
to ``stats``: lane steps, handed-off positions, warp rounds, and the steps
of each warp (its lanes' longest walk plus its rounds), the quantity that
sets the kernel's time.
"""

from __future__ import annotations

import collections
import pathlib
import re

import numpy as np

SWEEP_CU = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "sweep.cu"


def kernel_constants(source: pathlib.Path = SWEEP_CU) -> dict[str, int]:
    """The kernel's ``constexpr`` integers, read from its source."""
    pattern = r"constexpr (?:int|uint32_t) (k\w+) = (0x[0-9A-Fa-f]+|\d+)u?;"
    return {m.group(1): int(m.group(2), 0) for m in re.finditer(pattern, source.read_text())}


CONST = kernel_constants()
THREADS = CONST["kThreads"]
POS_BITS = CONST["kPosBits"]
DIGIT_BITS = CONST["kDigitBits"]
PASSES = CONST["kPasses"]
KEY_BITS = PASSES * DIGIT_BITS
HASH_MUL = CONST["kHashMul"]
BUDGET = CONST["kBudget"]
MAX_WORDS = CONST["kMaxWords"]
COARSE_STEP = CONST["kCoarseStep"]
LANES = 32


def bucket(k: np.ndarray) -> np.ndarray:
    """The bucketed length of a run of k whole matching words."""
    return np.select([k >= 16, k >= 8, k >= 4, k >= 2, k >= 1], [64, 32, 16, 8, 4], 0)


def words(blocks: np.ndarray, lens: np.ndarray, n: int) -> np.ndarray:
    """W[b, p] for p < n, uint32: bytes p..p+3, zero at and past lens[b]."""
    nb, bs = blocks.shape
    data = np.zeros((nb, n + 3), np.uint32)
    data[:, :bs] = np.where(np.arange(bs)[None, :] < lens[:, None], blocks, 0)
    return data[:, :n] | data[:, 1 : n + 1] << 8 | data[:, 2 : n + 2] << 16 | data[:, 3 : n + 3] << 24


def keys(w: np.ndarray, lens: np.ndarray, key_bits: int = KEY_BITS) -> np.ndarray:
    """The key of every position: the hash's top key_bits bits, all ones
    where fewer than 4 bytes are left."""
    h = (w.astype(np.uint64) * HASH_MUL & 0xFFFFFFFF) >> (32 - key_bits)
    live = np.arange(w.shape[1])[None, :] + 4 <= lens[:, None]
    return np.where(live, h, (1 << key_bits) - 1).astype(np.uint32)


def radix_rank(sort_words: np.ndarray, threads: int = THREADS) -> np.ndarray:
    """The kernel's sort of each row of sort_words [nb, n] (n a multiple of
    threads) on the key field: PASSES passes of DIGIT_BITS bits, warp k
    owning words [k * n / warps, (k + 1) * n / warps)."""
    nb, n = sort_words.shape
    nw = threads // LANES
    span = n // nw
    bins = 1 << DIGIT_BITS
    rows = np.arange(nb)[:, None]
    warp = np.repeat(np.arange(nw), span)[None, :]
    shift = POS_BITS
    for _ in range(PASSES):
        d = ((sort_words >> np.uint32(shift)) & np.uint32(bins - 1)).astype(np.int64)
        # Digit counts per slice, scanned digit-major, warp-minor.
        counts = np.bincount(((rows * bins + d) * nw + warp).ravel(), minlength=nb * bins * nw).reshape(nb, bins * nw)
        offs = np.cumsum(counts, axis=1) - counts
        # Earlier words of the same digit in the same slice.
        ds = d.reshape(nb * nw, span)
        order = np.argsort(ds, axis=1, kind="stable")
        per_slice = counts.reshape(nb, bins, nw).transpose(0, 2, 1).reshape(nb * nw, bins)
        starts = np.cumsum(per_slice, axis=1) - per_slice
        sd = np.take_along_axis(ds, order, axis=1)
        before = np.empty_like(ds)
        np.put_along_axis(before, order, np.arange(span)[None, :] - np.take_along_axis(starts, sd, axis=1), axis=1)
        pos = np.take_along_axis(offs, d * nw + warp, axis=1) + before.reshape(nb, n)
        assert (np.sort(pos, axis=1) == np.arange(n)[None, :]).all()  # a permutation of each row
        out = np.empty_like(sort_words)
        out[np.broadcast_to(rows, pos.shape), pos] = sort_words
        sort_words = out
        shift += DIGIT_BITS
    return sort_words


def run_words(w, b, p, q, maxk):
    """Whole matching words from p and q = p - d, the first one known equal:
    at most maxk."""
    k = np.ones_like(p)
    alive = k < maxk
    n = w.shape[1]
    for j in range(1, MAX_WORDS):
        at = np.minimum(p + 4 * j, n - 1), np.minimum(q + 4 * j, n - 1)
        alive &= w[b, at[0]] == w[b, at[1]]
        k += alive
        alive &= k < maxk
    return k


def _visit(w, b, p, q, best_len, floor, maxk, stats, counted):
    """The bucket of the entry's run where it may beat best_len, else 0: the
    last word the beating run needs must match, and at least floor words.
    Counts the entries (where ``counted``) rejected by that last word and
    those rejected for a run shorter than floor."""
    need = np.maximum(floor, best_len >> 1) - 1
    n = w.shape[1]
    ok = w[b, np.minimum(q + 4 * need, n - 1)] == w[b, np.minimum(p + 4 * need, n - 1)]
    k = run_words(w, b, p, q, maxk)
    stats["last_word_rejects"] += int((counted & ~ok).sum())
    stats["short_granular_runs"] += int((counted & ok & (k < floor)).sum())
    return np.where(ok & (k >= floor), bucket(k), 0)


def sweep_table(
    blocks: np.ndarray, lens: np.ndarray, window: int, coarse_window: int = 0, granular: bool = False, *,
    budget: int = BUDGET, key_bits: int = KEY_BITS, threads: int = THREADS, stats: collections.Counter | None = None,
    walked: list | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(mlen uint8[nb, bs], mlag int16[nb, bs]) as ``csrc/sweep.cu`` computes
    them for blocks uint8[nb, bs] and lens int32[nb], the knobs as
    ``hopper_sweep.sweep_knobs`` gives them. A smaller key_bits forces key
    collisions; budget is the lane walk's entries before the handoff. With
    ``walked`` (a list) it appends the entries each walking position read:
    its lane steps and 32 a warp round."""
    stats = collections.Counter() if stats is None else stats
    nb, bs = blocks.shape
    lens = np.clip(lens.astype(np.int64), 0, bs)
    coarse = coarse_window > window
    sampled, granular = coarse and not granular, coarse and granular
    n = -(-bs // threads) * threads
    w = words(blocks, lens, n)
    key = keys(w, lens, key_bits)
    pos = np.arange(n, dtype=np.uint32)
    table = radix_rank((key << np.uint32(POS_BITS)) | pos[None, :], threads)
    rank = np.empty((nb, n), np.int64)
    rank[np.arange(nb)[:, None], (table & np.uint32((1 << POS_BITS) - 1)).astype(np.int64)] = np.arange(n)

    b, p = np.nonzero(np.arange(n)[None, :] + 4 <= lens[:, None])  # the positions that walk
    b, p = b.astype(np.int64), p.astype(np.int64)
    w0, k0 = w[b, p], key[b, p]
    maxk = np.minimum(MAX_WORDS, (lens[b] - p) >> 2)
    top = bucket(maxk)
    far_reach = sampled | (granular & (p % 8 == 0) & (p + 8 <= lens[b]))
    reach = np.where(far_reach, coarse_window, window)
    # The entries below p's rank are below its own word; they have its key
    # and a lag within its reach exactly when they are at least lo.
    lo = (k0.astype(np.int64) << POS_BITS) | np.maximum(p - reach, 0)
    r = rank[b, p] - 1
    best_len = np.zeros_like(p)
    best_d = np.zeros_like(p)
    open_ = np.ones(len(p), bool)
    steps = np.zeros_like(p)

    def entry(i, rr):
        """(ended, d, passes) of entries rr of positions i: the chain or the
        reach ended there, the lag, and whether the entry is a candidate
        (not a sampled lag off the stride, not a key collision)."""
        e = table[b[i], np.maximum(rr, 0)]
        d = p[i] - (e & np.uint32((1 << POS_BITS) - 1)).astype(np.int64)
        ended = (rr < 0) | (e < lo[i])
        filtered = (d > window) & sampled & (d % COARSE_STEP != 0)
        same = w[b[i], np.maximum(p[i] - d, 0)] == w0[i]
        stats["sampled_filtered"] += int((~ended & filtered).sum())
        stats["collisions"] += int((~ended & ~filtered & ~same).sum())
        return ended, d, ~ended & ~filtered & same

    # The lane walk: each position its own chain, nearest first, at most budget entries.
    for _ in range(budget):
        i = np.flatnonzero(open_)
        if not len(i):
            break
        steps[i] += 1
        ended, d, cand = entry(i, r[i])
        open_[i[ended]] = False
        r[i] -= 1
        j, d = i[cand], d[cand]
        floor = np.where((d > window) & granular, 2, 1)
        length = _visit(w, b[j], p[j], p[j] - d, best_len[j], floor, maxk[j], stats, True)
        better = length > best_len[j]
        best_len[j[better]], best_d[j[better]] = length[better], d[better]
        exits = j[better & (length == top[j])]
        open_[exits] = False
        stats["lane_exits"] += len(exits)

    # The handoff: the warp walks an open position's rest, 32 entries a round.
    best = np.where(best_len > 0, (best_len << 16) | (0xFFFF - best_d), 0)
    rounds = np.zeros_like(p)
    h = np.flatnonzero(open_)
    stats["handed_off"] += len(h)
    lane = np.arange(LANES)
    while len(h):
        rounds[h] += 1
        rr = r[h][:, None] - lane[None, :]
        hh = np.repeat(h, LANES).reshape(len(h), LANES)
        ended, d, cand = entry(hh, rr)
        floor = np.where((d > window) & granular, 2, 1)
        length = _visit(w, b[hh], p[hh], p[hh] - d, np.broadcast_to((best[h] >> 16)[:, None], d.shape), floor,
                        maxk[hh], stats, cand)
        packed = np.where(cand & (length > 0), (length << 16) | (0xFFFF - d), 0)
        best[h] = np.maximum(best[h], packed.max(axis=1))
        done = ended.any(axis=1) | ((best[h] >> 16) == top[h])
        stats["round_exits"] += int(((best[h] >> 16) == top[h]).sum())
        r[h] -= LANES
        h = h[~done]

    out = np.zeros((nb, n), np.int64)
    out[b, p] = best
    mlen = out[:, :bs] >> 16
    mlag = np.where(mlen > 0, 0xFFFF - (out[:, :bs] & 0xFFFF), 0)

    # Steps: a warp takes 32 neighbouring positions; it waits for its
    # longest lane walk, then walks its handed-off positions' rounds.
    lane_steps = np.zeros((nb, n), np.int64)
    lane_steps[b, p] = steps
    warp_rounds = np.zeros((nb, n), np.int64)
    warp_rounds[b, p] = rounds
    per_warp = lane_steps.reshape(nb, -1, LANES).max(axis=2) + warp_rounds.reshape(nb, -1, LANES).sum(axis=2)
    if walked is not None:
        walked.append(steps + LANES * rounds)
    stats["positions"] += nb * bs
    stats["walks"] += len(p)
    stats["lane_steps"] += int(steps.sum())
    stats["rounds"] += int(rounds.sum())
    stats["warps"] += per_warp.size
    stats["warp_steps"] += int(per_warp.sum())
    stats["max_warp_steps"] = max(stats["max_warp_steps"], int(per_warp.max(initial=0)))
    return mlen.astype(np.uint8), mlag.astype(np.int16)
