"""A NumPy mirror of the emit kernel's windowed walk, held against the plain version and the spec.

``csrc/emit.cu`` emits one block per warp, ``WARPS`` warps to a CTA. Each
warp stages ``WINDOW`` positions of its block (bytes zero at and past
``lens[b]``, match lengths and lags zero at and past ``block_size``) in its
own slice of shared memory, restaging from ``cursor & ~15`` when the walk's
next reads would leave the window: the cursor ``p`` reads positions ``p``
and ``p + 1`` (the lazy-1 lookahead), the literal-run scan at ``q`` reads
``q .. q + 32`` (32 lanes and each lane's lookahead). A literal run's
header and bytes go out 32 a step; where the scan's restaging has passed
the run's first bytes, or a step's bytes run past the window, the window
is restaged at them. Headers and bytes go into a ring of two ``HALF``-byte halves; a half is written to the
row when the output cursor passes it, clipped at ``cap``; at the end the
partial half, zeroed past the size, and zeros up to ``cap`` follow.

The mirror below follows those steps, reads only the window (an index
outside it raises), writes only through the ring, starts from a poisoned
output row (the wrapper allocates with ``torch.empty``) and runs the blocks
last first, so that a write past a row's end lands on a row already
finished. It must equal ``hopper_encode.emit_blocks_torch`` on every byte
and size, and ``lane_model_encode.lazy_defer`` + ``greedy_parse`` +
``layout_and_emit`` where the spec takes the same inputs (``cap`` at or
above every size). Exact: integers.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import pytest
import torch

from pim_compression_tpu.ops import lane_model_encode as lme
from pim_compression_tpu_torch import TorchCodecConfig
from pim_compression_tpu_torch.ops import hopper_encode, hopper_match
from pim_compression_tpu_torch.runtime import pipeline
from pim_compression_tpu_torch.utils import streams

# One torch thread per test process: the xdist workers share the machine's cores.
torch.set_num_threads(1)

# The kernel's constants (csrc/emit.cu: kWarps, kWindow, kHalf, kCopyMargin, kScanMargin).
WARPS = 4
WINDOW = 1024
HALF = 1024
COPY_MARGIN = 2  # the cursor reads p and p + 1
SCAN_MARGIN = 33  # a scan step reads q .. q + 32
POISON = 0xEE


class _Window:
    """One warp's staged window: positions [base, base + size) of its block."""

    def __init__(self, flat_data, flat_len, flat_lag, row, n, bs, size):
        self.flat = flat_data, flat_len, flat_lag
        self.row, self.n, self.bs, self.size = row, n, bs, size
        self.base = -1

    def stage(self, base: int) -> None:
        assert base % 16 == 0  # 16-byte loads
        pos = base + np.arange(self.size)
        planes = []
        for flat, limit in zip(self.flat, (self.n, self.bs, self.bs)):
            ok = pos < limit
            plane = np.zeros(self.size, flat.dtype)
            plane[ok] = flat[self.row + pos[ok]]
            planes.append(plane)
        self.base = base
        self.data = planes[0].tobytes()
        self.lens = planes[1]
        self.len_list = planes[1].tolist()
        self.lags = planes[2].tolist()

    def index(self, pos: int) -> int:
        i = pos - self.base
        if not 0 <= i < self.size:
            raise IndexError(f"position {pos} outside the window [{self.base}, {self.base + self.size})")
        return i


def emit_window_model(blocks, lens, mlen, mlag, cap, window=WINDOW, half=HALF, warps=WARPS, stats=None):
    """The kernel's emit on numpy arrays: (comp uint8[nb, cap], sizes int32[nb]).

    ``stats`` (a Counter) collects how often each edge of the design was met.
    """
    assert window % 16 == 0 and window >= SCAN_MARGIN + 15
    assert half & (half - 1) == 0 and half >= 3 + 32  # a copy's tag or a 32-byte step past a full half
    stats = collections.Counter() if stats is None else stats
    nb, bs = blocks.shape
    flat_data = np.ascontiguousarray(blocks).reshape(-1)
    flat_len = np.ascontiguousarray(mlen).reshape(-1)
    flat_lag = np.ascontiguousarray(mlag).view(np.uint16).reshape(-1)  # lag bits, read unsigned
    guard = 64
    comp = np.full(nb * cap + guard, POISON, np.uint8)
    sizes = np.full(nb, -1, np.int32)
    vec = cap % 16 == 0  # 16-byte stores on an aligned row, else bytes
    mask = 2 * half - 1
    for cta in reversed(range(-(-nb // warps))):
        for warp in reversed(range(warps)):
            b = cta * warps + warp
            if b >= nb:
                stats["idle_warps"] += 1
                continue
            out = b * cap
            n = min(max(int(lens[b]), 0), bs)
            win = _Window(flat_data, flat_len, flat_lag, b * bs, n, bs, window)
            win.stage(0)
            ring = bytearray(2 * half)

            def write_half(start):
                src = ring[start & mask : (start & mask) + half]
                if vec:
                    for c in range(0, half, 16):
                        if start + c < cap:
                            comp[out + start + c : out + start + c + 16] = np.frombuffer(src[c : c + 16], np.uint8)
                else:
                    hi = min(start + half, cap)
                    if hi > start:
                        comp[out + start : out + hi] = np.frombuffer(src[: hi - start], np.uint8)
                if start < cap < start + half:
                    stats["clipped_flushes"] += 1
                elif start >= cap:
                    stats["flushes_past_cap"] += 1

            p = o = flushed = 0
            while p < n:
                if p + COPY_MARGIN > win.base + window:
                    win.stage(p & ~15)
                    stats["refills"] += 1
                i = win.index(p)
                l0, l1, off = win.len_list[i], win.len_list[win.index(p + 1)], win.lags[i]
                if p + 1 == win.base + window - 1:
                    stats["lookahead_at_window_end"] += 1
                if p + 1 == bs:
                    stats["lookahead_at_block_size"] += 1
                d = 0 if l1 > l0 else l0
                if d >= 4:  # copy: copy1 iff len < 12 and offset < 2048
                    one = d < 12 and off < 2048
                    if one:
                        word, h = 1 | ((d - 4) << 2) | ((off >> 8) << 5) | ((off & 0xFF) << 8), 2
                    else:
                        word, h = 2 | ((d - 1) << 2) | ((off & 0xFF) << 8) | (((off >> 8) & 0xFF) << 16), 3
                    for lane in range(h):
                        assert o + lane < flushed + 2 * half, "the ring overwrote bytes not yet written out"
                        ring[(o + lane) & mask] = (word >> (8 * lane)) & 0xFF
                    stats["copies"] += 1
                    stats["lags_from_32768"] += off >= 32768
                    if d == 64 and p + d + COPY_MARGIN > win.base + window:
                        stats["copy_64_across_margin"] += 1
                    o += h
                    p += d
                    if o - flushed >= half:
                        write_half(flushed)
                        flushed += half
                    continue
                # literal run [p, end): a ballot per 32 positions finds its end
                end, q, moved = n, p + 1, False
                while q < n:
                    if q + SCAN_MARGIN > win.base + window:
                        win.stage(q & ~15)
                        stats["refills"] += 1
                        moved = True
                    j = win.index(q)
                    win.index(q + 32)
                    a, c = win.lens[j : j + 32].astype(np.int32), win.lens[j + 1 : j + 33].astype(np.int32)
                    stop = (q + np.arange(32) >= n) | (np.where(c > a, 0, a) >= 4)
                    if stop.any():
                        end = min(q + int(np.argmax(stop)), n)
                        break
                    q += 32
                run = end - p
                lit = run - 1
                h = 1 if lit < 60 else (2 if lit < 256 else 3)
                hdr = lit << 2 if h == 1 else ((60 if h == 2 else 61) << 2) | (lit << 8)
                total = h + run
                for k in range(0, total, 32):  # 32 output bytes a step
                    lo, hi = p + max(k - h, 0), min(p + k + 31 - h, end - 1)
                    if lo < win.base or hi >= win.base + window:
                        stats["copy_restages"] += 1
                        stats["copy_restages_behind"] += lo < win.base
                        win.stage(lo & ~15)
                    for lane in range(min(32, total - k)):
                        t = k + lane
                        if t < h:
                            v = (hdr >> (8 * t)) & 0xFF
                        else:
                            v = win.data[win.index(p + t - h)]
                        assert o + t < flushed + 2 * half, "the ring overwrote bytes not yet written out"
                        ring[(o + t) & mask] = v
                    if o + min(k + 32, total) - flushed >= half:
                        write_half(flushed)
                        flushed += half
                stats["literal_runs"] += 1
                stats["runs_across_refills"] += moved
                stats["runs_longer_than_window"] += run > window
                if end in (win.base, win.base + window - 1) or end % window == 0:
                    stats["runs_ending_at_window_edge"] += 1
                o += total
                p = end
            for t in range(o, flushed + half):  # the partial half, zero past the size
                ring[t & mask] = 0
            write_half(flushed)
            comp[out + flushed + half : out + cap] = 0
            sizes[b] = o
            stats["blocks"] += 1
            stats["sizes_past_cap"] += o > cap
            stats["empty_blocks"] += n == 0
    assert (comp[nb * cap :] == POISON).all(), "a write past the last row"
    return comp[: nb * cap].reshape(nb, cap), sizes, stats


# --- inputs -------------------------------------------------------------

BLOCK_SIZES = [256, 4096, 32768, 65536]


@functools.lru_cache(maxsize=None)
def matched_inputs(bs: int):
    """Text, plain, hand-built and far-repeat blocks with the matcher's
    lengths and lags at the zero-flag config (the ``sel_all`` ladder above
    32768), ``cap`` the padded capacity."""
    text = np.frombuffer(streams.text_payload(2 * bs, bs + 1), np.uint8).reshape(2, bs)
    rb, rl = streams.plain_blocks(bs, 3 if bs > 4096 else 11, bs)
    hb, hl = streams.hand_plain_blocks(bs, bs)
    far = np.frombuffer(streams.far_repeat_block(bs, 2), np.uint8)[None]
    blocks = np.concatenate([text, rb, hb, far])
    lens = np.concatenate([np.full(2, bs, np.int32), rl, hl, np.full(1, bs, np.int32)])
    knobs = hopper_encode.encode_knobs(TorchCodecConfig(block_size=bs))
    mlen, mlag = hopper_match.match_blocks_torch(torch.from_numpy(blocks), torch.from_numpy(lens), **knobs)
    return blocks, lens, mlen.numpy(), mlag.numpy(), pipeline.padded_capacity(bs)


@functools.lru_cache(maxsize=None)
def synthetic_inputs(bs: int, odd_cap: bool):
    """``streams.synthetic_matches``, with a ``cap`` below the larger sizes
    (odd: not a multiple of 16, so the byte-wise stores)."""
    return (*streams.synthetic_matches(bs, bs * 2 + odd_cap), bs // 2 + (5 if odd_cap else 16))


def inputs(kind: str, bs: int):
    return matched_inputs(bs) if kind == "matched" else synthetic_inputs(bs, kind == "synthetic-odd-cap")


@functools.lru_cache(maxsize=None)
def plain_emit(kind: str, bs: int):
    blocks, lens, mlen, mlag, cap = inputs(kind, bs)
    comp, sizes = hopper_encode.emit_blocks_torch(*map(torch.from_numpy, (blocks, lens, mlen, mlag)), cap)
    return comp.numpy(), sizes.numpy()


# (window, half): two small ones, so that every edge is met many times in a
# block, and the kernel's own.
GEOMETRIES = [(128, 64), (256, 128), (WINDOW, HALF)]
KINDS = ["matched", "synthetic", "synthetic-odd-cap"]
STATS: dict = {}


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window, half", GEOMETRIES, ids=[f"w{w}-h{h}" for w, h in GEOMETRIES])
def test_mirror_matches_plain_emit(window, half, kind, bs):
    blocks, lens, mlen, mlag, cap = inputs(kind, bs)
    stats = collections.Counter()
    comp, sizes, _ = emit_window_model(blocks, lens, mlen, mlag, cap, window, half, stats=stats)
    want_comp, want_sizes = plain_emit(kind, bs)
    np.testing.assert_array_equal(sizes, want_sizes)
    np.testing.assert_array_equal(comp, want_comp)
    STATS[(window, half, kind, bs)] = stats
    if kind != "matched":
        assert stats["sizes_past_cap"] > 0 and stats["empty_blocks"] == 1
    if bs > window:
        assert stats["refills"] > 0


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_mirror_matches_lane_model(bs):
    """The kernel's constants against the spec, on the matcher's output."""
    blocks, lens, mlen, mlag, cap = matched_inputs(bs)
    comp, sizes, _ = emit_window_model(blocks, lens, mlen, mlag, cap)
    best_len = mlen.T.astype(np.int32)
    deferred = lme.lazy_defer(best_len)
    accept, is_copy = lme.greedy_parse(deferred, lens)
    best_off = mlag.T.view(np.uint16).astype(np.int32)
    comp_ref, sizes_ref = lme.layout_and_emit(blocks.T.astype(np.int32), lens, accept, is_copy, deferred, best_off, cap)
    assert (sizes <= cap).all()
    np.testing.assert_array_equal(sizes, sizes_ref)
    np.testing.assert_array_equal(comp, comp_ref.T)


def test_mirror_meets_every_trouble_spot():
    """Summed over the small windows' cases, each edge of the design was met."""
    total = collections.Counter()
    for window, half in GEOMETRIES[:2]:
        for kind in KINDS:
            for bs in BLOCK_SIZES:
                key = (window, half, kind, bs)
                if key not in STATS:  # run alone: compute it here
                    stats = collections.Counter()
                    emit_window_model(*inputs(kind, bs), window, half, stats=stats)
                    STATS[key] = stats
                total += STATS[key]
    for spot in ("lookahead_at_window_end", "lookahead_at_block_size", "lags_from_32768", "clipped_flushes",
                 "flushes_past_cap", "copy_64_across_margin", "runs_across_refills", "runs_longer_than_window",
                 "copy_restages", "copy_restages_behind", "runs_ending_at_window_edge", "empty_blocks", "idle_warps"):
        assert total[spot] > 0, spot
