"""A NumPy mirror of the decode kernel's walk (``csrc/decode.cu``): its payload window, history ring and paths.

``decode_window_model`` runs one warp's walk per block as the kernel does
and checks every read on the way; ``tests/test_torch_decode_window.py``
holds it against the plain version, the oracle and the spec, and describes
the design. Its ``stats`` count how often each edge of the design was met,
and what the traced kernel counts: ``elements`` walked, those on the short
paths (``short_path_copies``, ``short_path_literals``; every other element
takes the general path), ``copied_bytes`` by valid copy elements and
``row_reads``, those of them read from the row past the ring
(``tests/test_torch_cuda.py`` holds the kernel's counters to them). It
imports no JAX, so it runs beside the card too.
"""

from __future__ import annotations

import collections

import numpy as np

from pim_compression_tpu_torch.ops import hopper_decode

# The kernel's constants (csrc/decode.cu), checked against its source by tests/test_torch_decode_window.py.
WARPS = 4
RING = 16384
CHUNK = 4096
HALF = 1024
HEADER_MARGIN = 8  # the header's two aligned words from p & ~3
STEP = 32  # payload bytes a literal step moves
POISON = 0xEE
LEN, BAD, OVERRUN = hopper_decode.ERR_LENGTH_MISMATCH, hopper_decode.ERR_BAD_OFFSET, hopper_decode.ERR_ELEMENT_OVERRUN


class _Window:
    """One warp's payload window: halves in flight or arrived, every slot's position."""

    def __init__(self, src: bytes, clen: int, half: int, stats):
        self.src, self.clen, self.half, self.stats = src, clen, half, stats
        self.mask = 2 * half - 1
        self.slots = bytearray(2 * half)
        self.slot_pos = [-1] * (2 * half)
        self.arrived = [False] * (2 * half)
        self.pending = collections.deque()  # half starts in flight, oldest first
        self.base = self.ready = 0
        self.last_pos = 0
        self.stage(0)
        self.stage(half)

    def stage(self, at: int) -> None:
        assert at % self.half == 0 and at >= 0
        lo = at & self.mask
        for j in range(self.half):
            q = at + j
            self.slots[lo + j] = self.src[q] if q < self.clen else 0  # nothing at or past clen is read
            self.slot_pos[lo + j] = q
            self.arrived[lo + j] = False
        if at + self.half > self.clen:
            self.stats["stagings_past_comp_len"] += 1
        self.pending.append(at)

    def wait(self, keep: int) -> None:
        while len(self.pending) > keep:
            at = self.pending.popleft()
            lo = at & self.mask
            for j in range(self.half):
                self.arrived[lo + j] = True

    def ready_for(self, pos: int, end: int) -> bool:
        """Whether [pos, end) can be read with no refill (the kernel's limits)."""
        return not (end > self.ready or pos >= self.base + self.half)

    def need(self, pos: int, end: int) -> None:
        """The kernel's test before a read of [pos, end), then its refill."""
        assert pos >= self.last_pos and end - pos <= self.half
        self.last_pos = pos
        if not (end > self.ready or pos >= self.base + self.half):
            return
        half = self.half
        if pos >= self.base + half:
            if pos >= self.base + 2 * half:
                self.wait(0)
                self.base = pos & ~(half - 1)
                self.ready = self.base
                self.stage(self.base)
                self.stats["window_restages"] += 1
            else:
                self.base += half
                self.stats["window_slides"] += 1
            self.stage(self.base + half)
        if end > self.ready:
            if end <= self.base + half:
                self.wait(1)
                self.ready = self.base + half
                self.stats["waits_first_half"] += 1
            else:
                self.wait(0)
                self.ready = self.base + 2 * half
                self.stats["waits_both_halves"] += 1

    def read(self, pos: int, n: int) -> bytes:
        out = bytearray(n)
        for j in range(n):
            slot = (pos + j) & self.mask
            assert self.arrived[slot], f"payload byte {pos + j} read before it arrived"
            assert self.slot_pos[slot] == pos + j, f"slot {slot} holds {self.slot_pos[slot]}, not {pos + j}"
            out[j] = self.slots[slot]
        return bytes(out)

    def header(self, p: int) -> tuple[int, int]:
        """(tag, the four bytes after it) from the two aligned words at p & ~3."""
        a = p & ~3
        if (a >> 2) & (self.mask >> 2) == self.mask >> 2:
            self.stats["header_words_wrap"] += 1
        if (a & ~(self.half - 1)) != ((a + 7) & ~(self.half - 1)):
            self.stats["headers_across_halves"] += 1
        word = self.read(a, 8)
        h = word[p - a : p - a + 5]
        return h[0], int.from_bytes(h[1:5], "little")


class _Ring:
    """One warp's history ring, its flushes, and the block's output row."""

    def __init__(self, bs: int, ring: int, chunk: int, stats):
        self.bs, self.size, self.chunk, self.stats = bs, ring, chunk, stats
        self.mask = ring - 1
        self.vals = bytearray(ring)
        self.pos = [-1] * ring
        self.row = bytearray([POISON]) * bs
        self.written = bytearray(bs)
        self.flushed = 0

    def make_room(self, e: int) -> None:
        """One chunk at most: a write reaches at most 64 bytes past the last."""
        if e > self.flushed + self.size:
            start = self.flushed
            assert start + self.chunk <= self.bs
            for x in range(start, start + self.chunk):
                assert self.pos[x & self.mask] == x, f"flushing position {x}, not yet written"
                self.row[x] = self.vals[x & self.mask]
                self.written[x] = 1
            self.flushed += self.chunk
            self.stats["flushes"] += 1
        assert e <= self.flushed + self.size

    def write(self, x: int, value: int) -> None:
        slot = x & self.mask
        assert 0 <= x < self.bs
        assert self.pos[slot] < self.flushed, f"position {x} overwrites {self.pos[slot]}, not yet in the row"
        self.vals[slot] = value
        self.pos[slot] = x

    def read(self, s: int, near: int) -> int:
        if s >= near:
            assert self.pos[s & self.mask] == s, f"ring slot of {s} holds {self.pos[s & self.mask]}"
            return self.vals[s & self.mask]
        assert 0 <= s < self.flushed, f"row byte {s} read before its chunk was flushed"
        return self.row[s]

    def finish(self, w: int) -> bytes:
        for x in range(self.flushed, self.bs):
            if x < w:
                assert self.pos[x & self.mask] == x
                self.row[x] = self.vals[x & self.mask]
            else:
                self.row[x] = 0
            self.written[x] = 1
        assert all(self.written), "a byte of the row was never written"
        if w < self.bs:
            self.stats["zero_tails"] += 1
        return bytes(self.row)


def _copy_near(rg: _Ring, o: int, e: int, off: int) -> None:
    """The kernel's copy_near: no overlap, every source in the ring, every load before the stores."""
    assert off >= e - o and o - off >= e - rg.size
    values = [rg.read(o + k - off, e - rg.size) for k in range(e - o)]
    for k, value in enumerate(values):
        rg.write(o + k, value)


def _walk(src: bytes, clen: int, olen: int, bs: int, ring: int, chunk: int, half: int, stats) -> tuple[bytes, int]:
    """One warp's walk of one block, as csrc/decode.cu runs it."""
    win = _Window(src, clen, half, stats)
    rg = _Ring(bs, ring, chunk, stats)
    err = LEN if olen < 0 or olen > bs else 0
    wlim = min(max(olen, 0), bs)
    p = o = 0
    tag = after = 0
    if p < clen:
        win.need(p, p + HEADER_MARGIN)
        tag, after = win.header(p)
    while p < clen:
        stats["elements"] += 1
        if err:
            stats["elements_after_an_error"] += 1
        kind = tag & 3
        if kind == 0:
            short = (tag >> 2) + 1
            if (short <= 32 and p + 1 + short <= clen and o + short <= wlim and win.ready_for(p + 1, p + 1 + STEP)
                    and win.ready_for(p + 1 + short, p + 1 + short + HEADER_MARGIN) and o + short <= rg.flushed + ring):
                # The kernel's short path: one step, no refill, no flush, no error.
                win.need(p + 1, p + 1 + STEP)
                data = win.read(p + 1, STEP)  # every lane reads its byte
                p += 1 + short
                win.need(p, p + HEADER_MARGIN)
                tag, after = win.header(p)
                for lane in range(short):
                    rg.write(o + lane, data[lane])
                o += short
                stats["short_path_literals"] += 1
                continue
            n = (tag >> 2) - 59 if tag >= 240 else 0
            if p + 1 + n > clen:
                err |= OVERRUN
                stats["truncated_headers"] += 1
                break
            length = (tag >> 2) + 1
            if n:
                length = (after & (0xFFFFFF >> (8 * (3 - min(n, 3))))) + 1
                if n == 4 and after >> 24:
                    err |= OVERRUN
            lp = p + 1 + n
            take = min(length, clen - lp)
            if take > 0 and o + take > olen:
                err |= LEN
            wend = min(o + take, wlim)
            if wend - o > ring:
                stats["literals_longer_than_ring"] += 1
            for q in range(o, wend, STEP):
                at = lp + (q - o)
                win.need(at, at + STEP)
                end = min(q + STEP, wend)
                rg.make_room(end)
                data = win.read(at, STEP)  # every lane reads its byte
                for lane in range(end - q):
                    rg.write(q + lane, data[lane])
            o += take
            p = lp + take
            if take < length:
                err |= OVERRUN
                stats["literals_past_payload"] += 1
                break
            win.need(p, p + HEADER_MARGIN)  # past clen it reads the window's zeros
            tag, after = win.header(p)
        else:
            n = 4 if kind == 3 else kind
            length = ((tag >> 2) & 7) + 4 if kind == 1 else (tag >> 2) + 1
            if p + 1 + n > clen:
                err |= OVERRUN
                stats["truncated_headers"] += 1
                break
            off = ((tag >> 5) << 8) | (after & 0xFF) if kind == 1 else after & (0xFFFF if kind == 2 else 0xFFFFFF)
            high = kind == 3 and (after >> 24) != 0
            if (0 < off <= o and o + length <= wlim and length <= off <= ring - length and not high
                    and win.ready_for(p + 1 + n, p + 1 + n + HEADER_MARGIN) and o + length <= rg.flushed + ring):
                # The kernel's short path: no refill, no flush, no error, every source in the ring.
                p += 1 + n
                win.need(p, p + HEADER_MARGIN)
                tag, after = win.header(p)
                _copy_near(rg, o, o + length, off)
                o += length
                stats["short_path_copies"] += 1
                stats["copied_bytes"] += length
                continue
            p += 1 + n
            win.need(p, p + HEADER_MARGIN)  # the next header, read before this copy's bytes
            next_tag, next_after = win.header(p)
            bad = off == 0 or off > o or off > bs or high
            if bad:
                err |= BAD
            if o + length > olen:
                err |= LEN
            if o < wlim:
                e = min(o + length, wlim)
                rg.make_room(e)
                near = e - ring
                values = []
                stats["copied_bytes"] += 0 if bad else e - o
                if not bad and off >= length and off <= ring - (e - o):  # the kernel's fast path
                    stats["fast_copies"] += 1
                    _copy_near(rg, o, e, off)
                elif bad:
                    values = [0] * (e - o)
                    stats["bad_copies_zeroed"] += 1
                else:
                    d = off
                    far = 0
                    for k in range(e - o):
                        lane, upper = k & 31, k >= 32
                        if d < length:  # period position: lane % d, then + 32 % d once
                            r = lane % d
                            if upper:
                                r += 32 % d
                                if r >= d:
                                    r -= d
                            s = o - d + r
                        else:
                            s = o + k - d
                        far += s < near
                        values.append(rg.read(s, near))
                    stats["overlapping_copies"] += d < length
                    stats["row_reads"] += far
                    stats["copies_reading_the_row"] += far > 0
                    stats["copies_straddling_the_ring"] += 0 < far < e - o
                    stats["offsets_from_32768"] += d >= 32768
                for k, value in enumerate(values):  # every load before the stores
                    rg.write(o + k, value)
            o += length
            tag, after = next_tag, next_after
    if o != olen:
        err |= LEN
    win.wait(0)
    return rg.finish(min(o, wlim)), err


def decode_window_model(comp, clen, olen, bs, ring=RING, chunk=CHUNK, half=HALF, stats=None):
    """The kernel's decode on numpy arrays: (out uint8[nb, bs], err int32[nb]).

    ``stats`` (a Counter) collects how often each edge of the design was met.
    """
    assert ring & (ring - 1) == 0 and ring % chunk == 0 and chunk <= ring - 64
    assert half & (half - 1) == 0 and half >= max(STEP, HEADER_MARGIN) and half % 16 == 0
    stats = collections.Counter() if stats is None else stats
    nb, cap = comp.shape
    out = np.empty((nb, bs), np.uint8)
    err = np.empty(nb, np.int32)
    for cta in reversed(range(-(-nb // WARPS))):
        for warp in reversed(range(WARPS)):
            b = cta * WARPS + warp
            if b >= nb:
                stats["idle_warps"] += 1
                continue
            n = min(max(int(clen[b]), 0), cap)
            row, e = _walk(comp[b].tobytes(), n, int(olen[b]), bs, ring, chunk, half, stats)
            out[b] = np.frombuffer(row, np.uint8)
            err[b] = e
            stats["blocks"] += 1
            stats["empty_payloads"] += n == 0
            stats["payload_not_16_byte_multiple"] += n % 16 != 0
    return out, err
