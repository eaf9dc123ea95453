// Block decode for the block-parallel modified-Snappy format, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package that decode a batch, on both
// of its paths:
//   pim_compression_tpu/ops/pallas_decode.py::_dfa_kernel          K1, parse DFA
//       (narrow, and wide=True: a 17-bit dst and an int16 value plane)
//   pim_compression_tpu/ops/pallas_decode.py::_route_kernel        K2, route/fill/resolve
//   pim_compression_tpu/ops/pallas_decode.py::_route_kernel_wide   K2 for 32 KB < bs <= 64 KB
// The TPU needs the wide path because its tokens pack a row and a value into
// one int32; a serial walk holds both in registers, so one kernel serves
// every block size. The TPU design (a lockstep DFA over 1024 lanes,
// compact/expand routing, prefix-max fill, pointer doubling) exists because
// a TPU lane has no random access. Hopper has it, so a warp decodes a block
// the way the host decoder does (oracle.decompress_block): it walks the tags
// serially and copies each literal or match with its 32 lanes.
//
// What bounds it on this card: the dependent chain of the batch's slowest
// block, not bytes. Each element is a header read, its decode and its copy,
// and the next element's header cannot be read before this one's length is
// known; the payload in and the block out are far below the memory rate.
// So the design keeps every walk resident and every read of the chain in
// shared memory:
// - One warp per block, kWarps warps to a CTA (grid ceil(nb / kWarps)), no
//   CTA-wide barrier; a warp past num_blocks returns at once. Each warp's
//   shared memory is kWarpBytes (18 KB) whatever the block size or cap, so
//   three CTAs, 12 walks, share an SM and a 1024-block batch is one wave at
//   every block size (pim_decode_walks_per_sm reports it).
// - A payload window of two kHalf-byte halves per warp: payload byte q in
//   win[q & (2 * kHalf - 1)], zero at and past comp_len (nothing there is
//   read). The halves are filled by 16-byte cp.async copies, one commit
//   group per half, so the next half is in flight while the walk reads the
//   current one; when the walk's lowest needed byte leaves the first half,
//   that half's slots take the half after the second (after a __syncwarp:
//   every lane has read it). A read of [pos, end) waits only when end is
//   past the bytes that have arrived: the header reads the two aligned words
//   from p & ~3 (kHeaderMargin = 8 covers them and the 5-byte header), a
//   literal step kStep bytes.
// - A history ring of kRing output bytes per warp: position x in
//   ring[x & (kRing - 1)]. Chunks of kChunk bytes go out to the block's row
//   in 16-byte stores (byte stores where the row is not 16-byte aligned),
//   between two __syncwarp()s, only when a write needs their slots.
//   Invariant: an element writing positions [o, e) first flushes a chunk
//   when e > flushed + kRing (one is enough: a write reaches at most 64
//   bytes past the last, kChunk >= 64), so e <= flushed + kRing, every
//   position below e - kRing is in the row
//   (its chunk was flushed) and every position in [e - kRing, o) is still
//   in the ring (no position as far as x + kRing has been written). A
//   copy's source byte s is read from the ring when s >= e - kRing and from
//   the row otherwise, byte by byte, so a copy may straddle the boundary.
//   The row read is an ordinary coherent load of bytes this warp stored
//   before a __syncwarp() (no __ldg, no read-only alias of out).
// - The chain per element. A walk alone is a serial stream of dependent
//   instructions, ~3-4 cycles each on this card, so its time is about the
//   instructions an element issues. The common elements take short paths:
//   a copy with a valid offset, no overlap, every source in the ring, no
//   length error, no refill and no flush (one test of those conditions);
//   a literal of at most 32 bytes whose length is in its tag, likewise.
//   Each reads the next header's two aligned window words (one shift gives
//   the tag and the four bytes after it) before its own loads and stores,
//   and moves its bytes with one load and one store a lane for each 32.
//   Every other element takes the general path: the error bits, the
//   refill, the flush, and for a copy that reaches past the ring,
//   overlaps (offset < length: each lane takes its period position once,
//   lane % offset, not a % per byte) or has a bad offset, copy_slow. A
//   __syncwarp() ends each element (the next may copy what this one
//   wrote). scripts/decode_time.py measures the chain.
// At the end the ring's unflushed bytes, then zeros up to block_size, go
// to the row: every byte of the row is written (bytes from out_len on are
// 0), so the wrapper allocates with torch.empty. A copy with a bad offset
// writes zeros, so a malformed block's row is what the staged one-CTA
// design gave too.
// tests/test_torch_decode_window.py holds a NumPy mirror of this walk (the
// window's refill rule and margins, the ring, its flushes and the ring or
// row choice per source byte, the zero tail) against the plain version, the
// oracle and the spec.
//
// Traced (kTrace, trace.cuh): each walk, from its first header read to its
// last store, folds its %globaltimer span into the launch's record, and lane
// 0 adds its counts: c[0] elements walked, c[1] those that left the short
// paths for the general one, c[2] bytes copied by valid copy elements, c[3]
// those of them read from the row, past the ring (copy_slow's sources below
// e - kRing: none for an overlapping copy, which reads at most 64 bytes back).
// On an H100 the traced walk takes 3.7-4.4 % longer than the plain one on
// 1024-block batches of text; the span alone costs nothing, and the other
// placements of the counters tried (before the copy, branch-free, packed in
// one register, one counter a lane, in shared memory) cost as much or more.
//
// Error bits match the parse DFA (pim_compression_tpu/ops/lane_model.py:37-41,
// parse_dfa): ERR_LENGTH_MISMATCH, ERR_BAD_OFFSET and ERR_ELEMENT_OVERRUN are
// set under the DFA's conditions, in the order the walk meets them, and the
// walk goes on after a length or offset error as before. ERR_ROUTE_CONFLICT
// and ERR_UNRESOLVED come from the TPU routing and resolve stages; a serial
// decoder has neither stage and cannot produce them. On a block the DFA
// accepts, those stages set nothing either, so the verdict (err != 0) is the
// reference's on every block.
//
// Safety on malformed input: bytes at or past comp_len are never read, nothing
// is written outside the block's output row, and all lengths stay in 32-bit
// range (a literal takes at most the bytes left in the payload).

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace.cuh"

namespace {

constexpr int kErrLengthMismatch = 1;
constexpr int kErrBadOffset = 2;
constexpr int kErrElementOverrun = 4;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 16384;       // output bytes a warp keeps
constexpr int kChunk = 4096;       // output bytes a flush writes to the row
constexpr int kHalf = 1024;        // payload bytes in each half of a warp's window
constexpr int kHeaderMargin = 8;   // a header reads the two aligned words from p & ~3
constexpr int kStep = 32;          // payload bytes a literal step moves
constexpr int kMaxBlockSize = 65536;
constexpr int kRingMask = kRing - 1;
constexpr int kWinMask = 2 * kHalf - 1;
constexpr int kWordMask = 2 * kHalf / 4 - 1;
constexpr int kWarpBytes = kRing + 2 * kHalf;
constexpr int kSharedBytes = kWarps * kWarpBytes;

static_assert((kRing & (kRing - 1)) == 0, "the ring is indexed by a mask");
static_assert(kRing % kChunk == 0 && kChunk % 512 == 0, "chunks tile the ring in 16-byte pieces for 32 lanes");
static_assert(kChunk <= kRing - 64, "a chunk is fully written before a write (at most 64 bytes) needs its slots");
static_assert((kHalf & (kHalf - 1)) == 0 && kHalf % 512 == 0, "each lane stages whole 16-byte pieces of a half");
static_assert(kStep <= kHalf && kHeaderMargin <= kHalf, "a read fits the window once its first byte is in the first half");

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

// Stage payload bytes [at, at + kHalf) into their window slots, zero at and
// past clen; nothing at or past src[clen] is read. vec: 16-byte
// asynchronous copies, one commit group; otherwise byte loads.
__device__ __forceinline__ void stage_half(uint8_t* win, const uint8_t* src, int clen, bool vec, int at,
                                           int lane) {
  uint8_t* slots = win + (at & kWinMask);
#pragma unroll
  for (int k = 0; k < kHalf / 512; ++k) {
    const int piece = lane + 32 * k;
    const int q = at + 16 * piece;
    const int n = min(max(clen - q, 0), 16);
    if (vec) {
      cp_async16(slots + 16 * piece, n > 0 ? src + q : src, n);
    } else {
      union {
        uint4 vec;
        uint8_t bytes[16];
      } u;
#pragma unroll
      for (int j = 0; j < 16; ++j) u.bytes[j] = j < n ? src[q + j] : 0;
      reinterpret_cast<uint4*>(slots)[piece] = u.vec;
    }
  }
  if (vec) asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The warp's window holds payload bytes [base, base + 2 * kHalf); bytes
// [base, ready) have arrived and the halves from ready on are in flight,
// one commit group each, oldest first. Make [pos, end) readable, where pos
// (the lowest byte the walk still needs) never decreases and end - pos <=
// kHalf; returns the new (base, ready).
__device__ __noinline__ int2 refill(uint8_t* win, const uint8_t* src, int clen, bool vec, int base, int ready,
                                    int pos, int end, int lane) {
  if (pos >= base + kHalf) {
    __syncwarp();  // every lane has read the passed half
    if (pos >= base + 2 * kHalf) {  // both halves passed: restage at pos
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      base = pos & ~(kHalf - 1);
      ready = base;
      stage_half(win, src, clen, vec, base, lane);
    } else {
      base += kHalf;
    }
    stage_half(win, src, clen, vec, base + kHalf, lane);
  }
  if (end > ready) {
    if (end <= base + kHalf) {  // the first half; the second stays in flight
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      ready = base + kHalf;
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      ready = base + 2 * kHalf;
    }
    __syncwarp();  // every lane's copies are visible to every lane
  }
  return make_int2(base, ready);
}

// Write output positions [start, start + kChunk) from the ring to the row,
// between two __syncwarp()s (the ring's writes before it, the row's reads
// after it).
__device__ __noinline__ void flush(const uint8_t* ring, uint8_t* row, int start, bool vec, int lane) {
  __syncwarp();
  const uint8_t* src = ring + (start & kRingMask);
  if (vec) {
    for (int c = lane; c < kChunk / 16; c += 32) {
      reinterpret_cast<uint4*>(row + start)[c] = reinterpret_cast<const uint4*>(src)[c];
    }
  } else {
    for (int c = lane; c < kChunk; c += 32) row[start + c] = src[c];
  }
  __syncwarp();
}

// The window's place in the walk, in registers: a header read at p needs a
// refill when p > hdr_lim, a literal step at `at` when at > step_lim (one
// compare each for "past the arrived bytes or out of the first half").
struct Window {
  int base;
  int ready;
  int hdr_lim;
  int step_lim;
};

__device__ __forceinline__ void need(Window& w, uint8_t* win, const uint8_t* src, int clen, bool vec, int pos,
                                     int end, int lane) {
  const int2 r = refill(win, src, clen, vec, w.base, w.ready, pos, end, lane);
  w.base = r.x;
  w.ready = r.y;
  w.hdr_lim = min(w.ready - kHeaderMargin, w.base + kHalf - 1);
  w.step_lim = min(w.ready - kStep, w.base + kHalf - 1);
}

// The five header bytes at payload byte p (tag in bits 0-7) from the two
// aligned window words that hold them.
__device__ __forceinline__ uint64_t header(const uint32_t* words, int p) {
  const int wi = p >> 2;
  const uint32_t w0 = words[wi & kWordMask];
  const uint32_t w1 = words[(wi + 1) & kWordMask];
  return ((static_cast<uint64_t>(w1) << 32) | w0) >> (8 * (p & 3));
}

// A copy of output positions [o, e), e - o <= 64, that does not overlap
// (d >= e - o) and whose sources are all in the ring: one load and one store
// a lane for each 32 bytes, both loads before the stores.
__device__ __forceinline__ void copy_near(uint8_t* ring, int o, int e, int d, int lane) {
  const int x0 = o + lane;
  const uint8_t c0 = ring[(x0 - d) & kRingMask];
  const uint8_t c1 = ring[(x0 + 32 - d) & kRingMask];
  if (x0 < e) ring[x0 & kRingMask] = c0;
  if (x0 + 32 < e) ring[(x0 + 32) & kRingMask] = c1;
}

// A copy of output positions [o, e) that copy_near does not take: a bad
// offset (zeros), an overlapping copy (a run: byte o + k is byte
// o - d + k % d, decoded before o; each lane takes its period position once),
// or one whose sources reach below e - kRing (those bytes from the row).
__device__ __noinline__ void copy_slow(uint8_t* ring, const uint8_t* row, int o, int e, int d, int len, bool bad,
                                       int lane) {
  const int x0 = o + lane;
  const int x1 = x0 + 32;
  uint8_t c0 = 0;
  uint8_t c1 = 0;
  if (!bad) {
    int s0 = x0 - d;
    int s1 = x1 - d;
    if (d < len) {
      const int r0 = lane % d;
      int r1 = r0 + 32 % d;
      if (r1 >= d) r1 -= d;
      s0 = o - d + r0;
      s1 = o - d + r1;
    }
    const int near = e - kRing;  // sources from here on are in the ring, below it in the row
    if (x0 < e) c0 = s0 >= near ? ring[s0 & kRingMask] : row[s0];
    if (x1 < e) c1 = s1 >= near ? ring[s1 & kRingMask] : row[s1];
  }
  if (x0 < e) ring[x0 & kRingMask] = c0;
  if (x1 < e) ring[x1 & kRingMask] = c1;
}

template <bool kTrace>
__global__ void __launch_bounds__(kThreads)
decode_blocks_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ comp_len,
                     const int32_t* __restrict__ out_len, uint8_t* out, int32_t* __restrict__ err_out,
                     int num_blocks, int cap, int block_size, pim::TraceRecord* trace) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= num_blocks) return;
  uint8_t* ring = smem + warp * kWarpBytes;
  uint8_t* win = ring + kRing;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(win);

  const int clen = min(max(comp_len[b], 0), cap);
  const int olen = out_len[b];
  const uint8_t* src = comp + static_cast<size_t>(b) * cap;
  uint8_t* row = out + static_cast<size_t>(b) * block_size;  // written, then read back: no restrict
  const bool vec_in = (cap & 15) == 0 && (reinterpret_cast<uintptr_t>(comp) & 15) == 0;
  const bool vec_out = (block_size & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  int err = 0;
  if (olen < 0 || olen > block_size) err |= kErrLengthMismatch;  // outside the contract
  const int wlim = min(max(olen, 0), block_size);  // writes stay below this
  Window w{0, 0, -1, -1};
  stage_half(win, src, clen, vec_in, 0, lane);
  stage_half(win, src, clen, vec_in, kHalf, lane);
  int p = 0;        // payload cursor
  int o = 0;        // output cursor; may run past olen on a malformed block
  int flushed = 0;  // output bytes [0, flushed) are in the row
  uint64_t v = 0;   // the header at p
  // Traced: the walk's counts (the record's c[0] .. c[3]).
  [[maybe_unused]] int n_elements = 0, n_general = 0, n_copied = 0, n_from_row = 0;
  if constexpr (kTrace) {
    if (lane == 0) pim::trace_start(trace, pim::globaltimer());
  }
  if (p < clen) {
    need(w, win, src, clen, vec_in, p, p + kHeaderMargin, lane);
    v = header(words, p);
  }
  while (p < clen) {
    if constexpr (kTrace) ++n_elements;
    const uint32_t tag = static_cast<uint32_t>(v) & 0xFFu;
    const uint32_t after = static_cast<uint32_t>(v >> 8);  // the four bytes after the tag
    const uint32_t kind = tag & 3u;
    if (kind != 0) {  // copy with a 1-, 2- or 4-byte offset
      const int n = kind == 3 ? 4 : static_cast<int>(kind);
      const int len = kind == 1 ? static_cast<int>((tag >> 2) & 7u) + 4 : static_cast<int>(tag >> 2) + 1;
      if (p + 1 + n > clen) {  // truncated offset: the DFA ends in OFF
        if constexpr (kTrace) ++n_general;
        err |= kErrElementOverrun;
        break;
      }
      const uint32_t off = kind == 1 ? ((tag >> 5) << 8) | (after & 0xFFu)
                                     : after & (kind == 2 ? 0xFFFFu : 0xFFFFFFu);
      const bool high = kind == 3 && (after >> 24) != 0;  // a COPY_4 offset byte above 24 bits
      const int d = static_cast<int>(off);
      // The common copy, in few instructions: a valid offset (1 <= d <= o,
      // so d < block_size too), all of it below out_len (so no length
      // error), no overlap, every source in the ring, and neither a refill
      // for the next header nor a flush.
      if (off - 1u < static_cast<uint32_t>(o) && o + len <= wlim && d >= len && d <= kRing - len &&
          p + 1 + n <= w.hdr_lim && o + len <= flushed + kRing && !high) {
        p += 1 + n;
        v = header(words, p);  // the next header, read before this copy's bytes
        copy_near(ring, o, o + len, d, lane);
        o += len;
        if constexpr (kTrace) n_copied += len;
        __syncwarp();  // this element's bytes are visible to every lane
        continue;
      }
      if constexpr (kTrace) ++n_general;
      // off == 0 or off > o, past the block, or above 24 bits.
      const bool bad = off - 1u >= static_cast<uint32_t>(o) || off > static_cast<uint32_t>(block_size) || high;
      p += 1 + n;
      // The next header, read before this copy's bytes (the window is not
      // the ring, so the two reads overlap). Past clen it reads the
      // window's zeros and is not used.
      if (p > w.hdr_lim) need(w, win, src, clen, vec_in, p, p + kHeaderMargin, lane);
      v = header(words, p);
      if (bad) err |= kErrBadOffset;
      if (o + len > olen) err |= kErrLengthMismatch;
      if (o < wlim) {
        const int e = min(o + len, wlim);
        if (e > flushed + kRing) {  // one chunk makes room for up to kChunk >= 64 bytes
          flush(ring, row, flushed, vec_out, lane);
          flushed += kChunk;
        }
        if (!bad && d >= len && d <= kRing - (e - o)) {  // no overlap, every source in the ring
          copy_near(ring, o, e, d, lane);
        } else {
          copy_slow(ring, row, o, e, d, len, bad, lane);
        }
        if constexpr (kTrace) {
          if (!bad) {
            n_copied += e - o;
            if (d >= len) n_from_row += max(0, min(e, e - kRing + d) - o);  // sources x - d below e - kRing
          }
        }
      }
      o += len;
    } else {  // literal
      // The common literal, in few instructions: at most 32 bytes, its
      // length in the tag, all of it in the payload and below out_len, and
      // neither a refill nor a flush.
      const int lp = p + 1;
      const int short_len = static_cast<int>(tag >> 2) + 1;
      if (short_len <= 32 && lp + short_len <= clen && o + short_len <= wlim && lp <= w.step_lim &&
          lp + short_len <= w.hdr_lim && o + short_len <= flushed + kRing) {
        const uint8_t c = win[(lp + lane) & kWinMask];
        p = lp + short_len;
        v = header(words, p);
        if (lane < short_len) ring[(o + lane) & kRingMask] = c;
        o += short_len;
        __syncwarp();  // this element's bytes are visible to every lane
        continue;
      }
      if constexpr (kTrace) ++n_general;
      const int n = tag >= (60u << 2) ? static_cast<int>(tag >> 2) - 59 : 0;  // 1-4 length bytes
      if (p + 1 + n > clen) {  // truncated length: the DFA ends in EXT
        err |= kErrElementOverrun;
        break;
      }
      uint32_t len = (tag >> 2) + 1;
      if (n > 0) {
        len = (after & (0xFFFFFFu >> (8 * (3 - min(n, 3))))) + 1;  // <= 2^24
        if (n == 4 && (after >> 24) != 0) err |= kErrElementOverrun;  // > 24 bits
      }
      const int first = p + 1 + n;  // the literal's first payload byte
      const int avail = clen - first;
      const int take = len < static_cast<uint32_t>(avail) ? static_cast<int>(len) : avail;
      if (take > 0 && o + take > olen) err |= kErrLengthMismatch;
      const int wend = min(o + take, wlim);
      for (int q = o; q < wend; q += kStep) {  // kStep bytes a step, through the window
        const int at = first + (q - o);
        if (at > w.step_lim) need(w, win, src, clen, vec_in, at, at + kStep, lane);
        const int end = min(q + kStep, wend);
        if (end > flushed + kRing) {
          flush(ring, row, flushed, vec_out, lane);
          flushed += kChunk;
        }
        const int x = q + lane;
        const uint8_t c = win[(at + lane) & kWinMask];
        if (x < end) ring[x & kRingMask] = c;
      }
      o += take;
      p = first + take;
      if (static_cast<uint32_t>(take) < len) {  // payload ends inside the literal
        err |= kErrElementOverrun;
        break;
      }
      if (p > w.hdr_lim) need(w, win, src, clen, vec_in, p, p + kHeaderMargin, lane);
      v = header(words, p);
    }
    __syncwarp();  // this element's bytes are visible to every lane
  }
  if (o != olen) err |= kErrLengthMismatch;

  // The unflushed rest of the row: the decoded bytes below min(o, wlim),
  // then zeros up to block_size. No copy is left in flight.
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  const int wr = min(o, wlim);
  if (vec_out) {
    for (int piece = flushed / 16 + lane; piece < block_size / 16; piece += 32) {
      const int x = 16 * piece;
      union {
        uint4 vec;
        uint8_t bytes[16];
      } u;
      u.vec = make_uint4(0, 0, 0, 0);
      if (x + 16 <= wr) {
        u.vec = *reinterpret_cast<const uint4*>(ring + (x & kRingMask));
      } else if (x < wr) {
#pragma unroll
        for (int j = 0; j < 16; ++j) u.bytes[j] = x + j < wr ? ring[(x + j) & kRingMask] : 0;
      }
      reinterpret_cast<uint4*>(row)[piece] = u.vec;
    }
  } else {
    for (int x = flushed + lane; x < block_size; x += 32) row[x] = x < wr ? ring[x & kRingMask] : 0;
  }
  if (lane == 0) err_out[b] = err;
  if constexpr (kTrace) {
    if (lane == 0) {
      pim::trace_end(trace, pim::globaltimer());
      atomicAdd(&trace->c[0], static_cast<unsigned long long>(n_elements));
      atomicAdd(&trace->c[1], static_cast<unsigned long long>(n_general));
      atomicAdd(&trace->c[2], static_cast<unsigned long long>(n_copied));
      atomicAdd(&trace->c[3], static_cast<unsigned long long>(n_from_row));
    }
  }
}

// Let the kernel take kSharedBytes of dynamic shared memory, with the SM's
// largest shared-memory carveout, so that three CTAs fit on an SM.
template <bool kTrace>
cudaError_t configure() {
  cudaError_t st = cudaFuncSetAttribute(decode_blocks_kernel<kTrace>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kSharedBytes);
  if (st != cudaSuccess) return st;
  return cudaFuncSetAttribute(decode_blocks_kernel<kTrace>, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool kTrace>
cudaError_t launch(const void* comp, const void* comp_len, const void* out_len, void* out, void* err,
                   int num_blocks, int cap, int block_size, void* stream, void* trace) {
  const cudaError_t st = configure<kTrace>();
  if (st != cudaSuccess) return st;
  const int grid = (num_blocks + kWarps - 1) / kWarps;
  decode_blocks_kernel<kTrace><<<grid, kThreads, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_len),
      static_cast<const int32_t*>(out_len), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(err), num_blocks, cap, block_size, static_cast<pim::TraceRecord*>(trace));
  return cudaGetLastError();
}

}  // namespace

// Decode num_blocks blocks on `stream`. comp is uint8[num_blocks, cap];
// comp_len, out_len and err are int32[num_blocks]; out is
// uint8[num_blocks, block_size]. trace is a zeroed pim::TraceRecord on the
// device for the traced kernel, or null for the plain one. Returns
// cudaGetLastError() after the launch (0 on success). Does not synchronise.
extern "C" int pim_decode_blocks(const void* comp, const void* comp_len,
                                 const void* out_len, void* out, void* err,
                                 int num_blocks, int cap, int block_size,
                                 int device, void* stream, void* trace) {
  if (num_blocks <= 0) return 0;
  if (block_size <= 0 || block_size > kMaxBlockSize || cap <= 0) return cudaErrorInvalidValue;
  const cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  return static_cast<int>(
      trace ? launch<true>(comp, comp_len, out_len, out, err, num_blocks, cap, block_size, stream, trace)
            : launch<false>(comp, comp_len, out_len, out, err, num_blocks, cap, block_size, stream, trace));
}

// The blocks the decode kernel walks at once on one SM of `device`: the CTAs
// that fit times kWarps, one block a warp (the shared memory does not depend
// on the block size or cap, so neither does this), or minus the CUDA error.
extern "C" int pim_decode_walks_per_sm(int device) {
  cudaError_t st = cudaSetDevice(device);
  if (st == cudaSuccess) st = configure<false>();
  int ctas = 0;
  if (st == cudaSuccess) {
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, decode_blocks_kernel<false>, kThreads, kSharedBytes);
  }
  return st == cudaSuccess ? ctas * kWarps : -static_cast<int>(st);
}
