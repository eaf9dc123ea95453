"""The plain reference of the sweep configurations' whole encode, block by block.

Written for this benchmark from the encoder's published rules (those that
``pim_compression_tpu/ops/lane_model_encode.py`` states for
``match_search``, ``match_search_granular``, ``lazy_defer``,
``greedy_parse`` and ``layout_and_emit``, and the knob rule of
``pallas_encode.py:1228-1244``), in plain PyTorch on CPU tensors and in
integer arithmetic; it imports neither JAX nor the JAX package nor the
program. For one block of ``len`` bytes:

1. The knobs. The window is cut to the block size and rounded up to 32;
   the coarse reach is cut to the block size; a sampled coarse range is
   cut to whole chunks of 256 lags; a reach at or below the window means
   no coarse search.
2. The search. At position p and lag d the candidate is the run of
   matching 4-byte words ``W[p + 4k] == W[p - d + 4k]``, k = 0, 1, ...,
   each word inside the block (``p + 4k + 4 <= len``) and ``p >= d``, at
   most 16 words, bucketed to 4 bytes a word: 1 -> 4, 2 -> 8, 4 -> 16,
   8 -> 32, 16 -> 64 (the largest bucket it reaches). Every lag in
   ``[1, min(window, bs - 1)]`` is a candidate at every position. Past the
   window, sampled: every 8th lag ``window + 8, window + 16, ...`` up to
   ``min(coarse, bs - 1)`` at every position; granular: every lag in
   ``(window, min(coarse, bs - 1)]`` at positions ``p % 8 == 0``, counted
   from 2 words on. The position keeps the largest ``(bucket << 16) |
   (0xFFFF - d)``: longest, then nearest.
3. Lazy-1: a position's length becomes 0 where the next position's
   (searched) length is longer; the last position's next is 0.
4. The greedy parse from position 0: a position with a length of 4 or more
   starts a copy of that length at its lag and the parse goes on past it;
   any other position is a literal byte.
5. The element layout: each maximal run of literal bytes is one literal
   element (tag ``(n - 1) << 2`` for n <= 60, then tag 60 or 61 with the
   length less one in 1 or 2 bytes), each copy one copy element: lengths
   below 12 at lags below 2048 take the 2-byte form (``1 | (len - 4) << 2 |
   (lag >> 8) << 5``, ``lag & 0xFF``), the rest the 3-byte form (``2 |
   (len - 1) << 2``, the lag in 2 bytes, little-endian).

Departures from those rules: none. The search is exhaustive over the lags,
vectorised over chunks of ``LAG_CHUNK`` lags, each lag's run measured by
doubling (runs of 2, 4, 8 and 16 words from runs of half as many); an 8 KB
block at window 2048 and granular coarse 8192 takes about 0.4 s on one
core.
"""

from __future__ import annotations

import torch

MAX_BLOCK = 16384  # the sweep's block-size envelope
COARSE_STEP = 8  # the sampled coarse lags' stride
COARSE_CHUNK = 256  # a sampled coarse range is whole chunks of this many lags
LAG_CHUNK = 128  # lags compared at once (at 8 KB, 128 ran fastest of 32-1024 on one core)


def knobs(block_size: int, match_window: int, coarse_window: int = 0, granular: bool = False) -> tuple[int, int]:
    """(window, coarse) of a configuration's knobs, coarse 0 for no coarse
    search; raises ``ValueError`` outside the sweep's envelope."""
    if not 0 < block_size <= MAX_BLOCK:
        raise ValueError(f"the sweep takes block sizes in (0, {MAX_BLOCK}]")
    if match_window < 0 or coarse_window < 0:
        raise ValueError("the windows are >= 0")
    window = (min(match_window, block_size) + 31) // 32 * 32
    coarse = min(coarse_window, block_size)
    if granular and coarse > window and block_size % 256:
        raise ValueError("granular coarse matching needs block_size % 256 == 0")
    if not granular and coarse > window:
        coarse = window + (coarse - window) // COARSE_CHUNK * COARSE_CHUNK
    return window, coarse if coarse > window else 0


def _words(data: bytes) -> torch.Tensor:
    """int64 [n]: W[p] = bytes p..p+3, little-endian, for every p with 4
    bytes left; elsewhere -1 - p, a value no other position holds."""
    n = len(data)
    b = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(torch.int64)
    w = -1 - torch.arange(n, dtype=torch.int64)
    if n >= 4:
        w[: n - 3] = b[: n - 3] | b[1 : n - 2] << 8 | b[2 : n - 1] << 16 | b[3:] << 24
    return w


def _best(w: torch.Tensor, stride: int, lags: range, floor: int) -> torch.Tensor:
    """int32 [ceil(n / stride)]: at each position p = stride * i, the packed
    best ``(levels << 16) | (0xFFFF - d)`` over the lags d in ``lags`` (a
    range of step 1 or 8), where levels counts the run lengths reached, in
    words, of 1 (only where ``floor`` is 1), 2, 4, 8 and 16: the longest
    bucket, then the nearest lag. A levels of 0 is no match. The run's next
    word lies ``4 / stride`` positions of the plane on."""
    n = w.shape[0]
    plane = w[::stride]
    m = plane.shape[0]
    step = 4 // stride
    reach = lags[-1] if len(lags) else 0
    # Before the block: a value no position holds.
    padded = torch.cat([torch.full((reach,), -2 - n, dtype=torch.int64), w])
    score = torch.zeros(m, dtype=torch.int32)
    for i in range(0, len(lags), LAG_CHUNK):
        chunk = lags[i : i + LAG_CHUNK]
        # earlier[j, k] = W[stride k - d_j], d_j = chunk[-1] - lag step * j: a view of the padded words.
        earlier = padded.as_strided((len(chunk), m), (chunk.step, stride), reach - chunk[-1])
        run = earlier == plane[None, :]
        levels = run.to(torch.int32) if floor == 1 else torch.zeros(run.shape, dtype=torch.int32)
        for words in (2, 4, 8, 16):
            half = words // 2 * step  # a run of `words` words: one of half as many here and there
            longer = torch.zeros_like(run)
            longer[:, : m - half] = run[:, : m - half] & run[:, half:]
            run = longer
            levels += run
        d = torch.tensor(list(reversed(chunk)), dtype=torch.int32)
        score = torch.maximum(score, ((levels << 16) | (0xFFFF - d[:, None])).max(dim=0).values)
    return score


def search(data: bytes, block_size: int, window: int, coarse: int = 0,
           granular: bool = False) -> tuple[list, list]:
    """(lengths, lags) of every position of one block, knobs as ``knobs``
    gives them: the bucketed length (0 or 4..64) and its lag, 0 where
    nothing matched."""
    n = len(data)
    w = _words(data)
    fine = _best(w, 1, range(1, min(window, block_size - 1) + 1), 1)
    length = torch.where(fine >> 16 > 0, 2 << (fine >> 16), 0)  # 1..5 levels: 4..64 bytes
    lag = 0xFFFF - (fine & 0xFFFF)
    if coarse > window:
        top = min(coarse, block_size - 1)
        if granular:
            far = _best(w, 4, range(window + 1, top + 1), 2)[0::2]  # runs from 8-aligned positions
            far_length = torch.where(far >> 16 > 0, 4 << (far >> 16), 0)  # 1..4 levels: 8..64 bytes
        else:
            far = _best(w, 1, range(window + COARSE_STEP, top + 1, COARSE_STEP), 1)
            far_length = torch.where(far >> 16 > 0, 2 << (far >> 16), 0)
        at = slice(0, None, 8) if granular else slice(None)
        # Longest, then nearest: a far lag wins only with a longer run.
        longer = far_length > length[at]
        length[at] = torch.where(longer, far_length, length[at])
        lag[at] = torch.where(longer, 0xFFFF - (far & 0xFFFF), lag[at])
    lag = torch.where(length > 0, lag, 0)
    return length.tolist()[:n], lag.tolist()[:n]


def _literal(out: bytearray, data: bytes, start: int, end: int) -> None:
    n1 = end - start - 1
    if n1 < 60:
        out.append(n1 << 2)
    elif n1 < 256:
        out += bytes((60 << 2, n1))
    else:
        out += bytes((61 << 2, n1 & 0xFF, n1 >> 8))
    out += data[start:end]


def _copy(out: bytearray, length: int, lag: int) -> None:
    if length < 12 and lag < 2048:
        out += bytes((1 | (length - 4) << 2 | (lag >> 8) << 5, lag & 0xFF))
    else:
        out += bytes((2 | (length - 1) << 2, lag & 0xFF, lag >> 8))


def emit(data: bytes, lengths: list, lags: list) -> bytes:
    """Lazy-1, the greedy parse and the element layout of one block."""
    n = len(data)
    lazy = [0 if p + 1 < n and lengths[p + 1] > lengths[p] else lengths[p] for p in range(n)]
    out = bytearray()
    p = lit = 0
    while p < n:
        if lazy[p] >= 4:
            if lit < p:
                _literal(out, data, lit, p)
            _copy(out, lazy[p], lags[p])
            p += lazy[p]
            lit = p
        else:
            p += 1
    if lit < n:
        _literal(out, data, lit, n)
    return bytes(out)


def encode_block(data: bytes, block_size: int, window: int, coarse: int = 0, granular: bool = False) -> bytes:
    """The element stream of one block of ``len(data) <= block_size``
    bytes, knobs as ``knobs`` gives them."""
    return emit(data, *search(data, block_size, window, coarse, granular))


def encode_task(task: tuple) -> list[bytes]:
    """Pool task: ``(blocks, block_size, window, coarse, granular)``; each
    block's stream. One torch thread: a pool's workers share the cores."""
    blocks, block_size, window, coarse, granular = task
    torch.set_num_threads(1)
    return [encode_block(b, block_size, window, coarse, granular) for b in blocks]
