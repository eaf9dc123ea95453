// Match finding for the block-parallel modified-Snappy encoder, for Hopper (sm_90a).
//
// Replaces four TPU kernels of the JAX package and the XLA glue between them:
//   pim_compression_tpu/ops/pallas_match.py::_sort_rung_kernel      one per rung: hash
//       ladder, folded key, bitonic sort of (key << pos_bits) | row at stride 1, 2, 4
//       or 8 and with or without a sort window, nearest previous equal key as a lag,
//       then a second sort to unsort
//   pim_compression_tpu/ops/pallas_match.py::_extend_fold_kernel    exact extension
//       folded strictly-greater into a running best; at sel_cap/4 rounds the cheap
//       select of the per-rung ladder
//   pim_compression_tpu/ops/pallas_match.py::_prev_step_kernel      (j+1)-th previous
//       occurrence by lag composition
//   pim_compression_tpu/ops/pallas_match.py::_select_extend_kernel  sel_all capped
//       select of every candidate array, then the winner's full extension
//   the glue in sorted_match_groups: cap_lag, the rung pick, the per-rung ladder
//       (one_group), _neighbor_fold
// Its output equals lane_model_encode.match_search_sorted on every position, in
// each of its three selection modes (rung_pick=True; sel_all=True with sel_cap;
// the per-rung ladder), at any rung strides and sort window, run on the block
// padded to a power of two as pallas_encode does; and it equals the plain PyTorch
// transcription hopper_match.match_blocks_torch.
//
// Design: one CTA per block, block sizes up to 65536. The block's bytes are
// staged in shared memory (zero at and past lens[b], plus 64 zero bytes past
// the block, which is what the spec's zero-filled shifts read): before each
// rung's sort, which reuses their region, and once more for the selection.
// Restaging reads the row again from device memory (L2 for a wave's blocks).
//
// Candidates. A rung of stride s keys the rows p / s of the positions p = 0, s,
// 2s, ...; pos_bits is 15 unless the rung's padded row count (the block's
// power-of-two sort size over s) exceeds 32768, then 16
// (lane_model_encode.fold_key). The spec sorts the unique words
// (key << pos_bits) | row, whose rows start in ascending order, so a stable sort
// on the key field alone gives the same order, and a row's nearest previous
// equal key is its sorted predecessor when the keys are equal. Each rung builds
// the words of up to 32768 rows in row order in one shared-memory buffer (each
// thread hashes its rows straight from the bytes; no hash plane is kept between
// rungs), then ranks them by an LSD radix sort of the key field: two passes of
// 9+8 bits (pos_bits 15) or 8+8 (pos_bits 16), so at most 512 bins a pass.
// Each warp owns a contiguous slice of the buffer and walks it 32 rows a step,
// lane l on row base + 32 i + l, and owns a column of digit counts in shared
// memory: uint16 counts, those of digits 2j and 2j + 1 in word j * (warps + 1)
// of the column, so no other warp touches its words and its digits spread
// over the banks (radix.cuh, wide_slot). A pass is
//   1. a count sweep: the warp zeroes its column, then every thread reads its
//      slice's words and adds one to its digit's count by a shared-memory
//      atomic add: no ballots;
//   2. the CTA scans the counts once, exclusively, in digit-major, warp-minor
//      order, 2^bits / 32 adjacent counts a thread (scan_wide_counts), which
//      leaves each digit's first slot for the warp in its count;
//   3. a scatter sweep of the words read in step 1: a lane's rank in its step
//      is popc(peers & lanemask_lt), its peers the lanes with its digit (the
//      AND of the digit's 8-9 ballots or their complements; kMatchAny = 1
//      takes __match_any_sync); it adds the digit's running offset, read from
//      the warp's column, and the lowest peer writes the offset back moved on
//      by the peers' number, between two __syncwarp()s.
// Barriers: 4 a pass (after the counts, two in the scan, after the scatter)
// instead of one per bitonic stage, 8 a sort where three 6-bit passes took 12.
// The sort runs in place in one 128 KB buffer, as the bitonic sort did, so a
// thread keeps the words it read (32 at 1024 threads) across the barriers
// that separate reading the old order from writing the new one: all kHeld =
// 32 in registers. With three 6-bit passes, holding 32 spilled at the 64
// registers a thread may have at 1024 threads, and the words past the first
// 16 were parked in the byte region (kHeld = 16, still a variant); the wider
// passes, with no owned-bin masks in the count sweep, hold all 32 without a
// spill and ran 3-4.5 % faster than parking half. 512 threads with 64 words
// each in 128 registers ran 1.2-1.35x slower, with half the warps
// (scripts/match_variants.py on an H100; PERF.md §6). Rows past the last
// real one of the buffer take sentinels 0xFFFFFFFF, whose digits are all ones
// and which start last, so a stable sort keeps them last and the real words
// are the first sorted. Then one sweep over the sorted words takes each one's
// predecessor with an equal key and writes its lag x s by row into the byte
// region as uint16, and the rung's positions are copied out to its uint16 lag
// plane in device memory, coalesced, with 0 at positions off the stride (the
// TPU's unsort, its chunk-transposed word build, its compaction and its span
// sweeps have no counterpart).
//
// Sort windows. A window of W bytes takes a row's predecessor only from its own
// aligned group of G = W / s rows. After one sort of the whole chunk, the
// equal-key predecessor is the nearest previous row with that key; if it lies in
// the row's group (prev / G == row / G) it is the answer, and otherwise no
// earlier row of the group has the key, or it would be nearer. So a window costs
// one integer compare, and no sort is run per group.
//
// 64 KB blocks. 65536 sort words are 256 KB, past the 232448 bytes a CTA may
// use. A stride-1 rung with no window sorts each 32 KB half of the positions in
// turn in the one 128 KB buffer, and copies the sorted first half to a
// device-memory scratch fh. A position's nearest previous equal key is its
// predecessor in its own half's sorted run; a second-half position that is first
// of its key in its half takes the last first-half position with that key. Its
// keys are 16 bits (pos_bits 16), so a second scratch, last_idx (uint16[65536]
// a block), has a slot for every key: the first half's sweep writes into the
// key's slot the sorted index of each key's last word (one writer a present
// key, no atomics), and the second half reads w = fh[last_idx[key] & 0x7FFF]
// and takes w's row if w's key is the key: two dependent loads where an upper
// bound on the sorted keys took about 16. The table is never cleared. A slot
// of a key absent from the first half may hold anything (a stale index of an
// earlier rung or launch, or garbage), but fh is rewritten whole in every
// split rung, so such a slot points at a word of another key and is rejected;
// a present key's slot was written in this rung. A strided rung has at most
// 32768 rows, and a window's groups divide the 32768-row chunks, so neither
// needs the lookup.
//
// Selection, per position after the last rung, in one of three modes:
// - rung pick: the longest rung with a candidate, capped at max_lag, wins;
// - select (sel_all): each candidate array in order (each rung; after the
//   4-byte rung its 2nd..k-th previous occurrences, lag_{j+1}(p) = lag_j(p) +
//   near(p - lag_j(p)) read from the uncapped lag plane) gets an extension
//   capped at sel_cap bytes, and a strictly longer one wins;
// - the per-rung ladder: rung by rung, each candidate is extended exactly at
//   ext_cap and replaces the running best only when strictly longer (earlier
//   rungs and nearer prev candidates win ties). With prev_k >= 2 and sel_cap,
//   the 4-byte rung's k candidates first go through the capped select, and only
//   its winner is extended and folded.
// The rung pick and the select extend their winner exactly at ext_cap; the
// extension starts over rather than resuming from the capped state, which gives
// the same length. An extension compares 4 bytes a step: two aligned 32-bit
// shared loads joined by a funnel shift on each side, and the first differing
// byte from the xor's lowest set bit. The neighbor fold reads the pre-fold
// lengths and lags from shared memory after a barrier.
//
// Shared memory: the byte region max(round16(bs + 64), 2 * words) + the sort
// words 4 * words, words = max(min(n, 32768), 2 * threads) with n the power of
// two >= bs, + the warps' columns of counts 4 * (512 / 2) * (warps + 1) (the
// 64-bin passes took 2 * 64 * warps) + 128 bytes of scan totals: 230528 bytes
// at bs = 32768 and 230592 at 65536 (200832 and 200896 with 64 bins), and the
// traced kernel's 16 static bytes, under the 232448 a CTA may have, so still
// one CTA of 1024 threads per SM. 64 registers, no spills (ptxas, both
// instantiations).
//
// What bounds it: the warp instructions of the sort's scatter. Per rung and
// 32768 rows a pass is 1024 warp-steps of a count sweep (a load, the digit,
// one shared-memory atomic add) and 1024 of a scatter (8-9 ballots, each
// with a shift and a LOP3, the peers' rank, the running offset's load and
// store, the word's store), against the bitonic network's 120 stages of 16384
// compare-exchanges. Measured on an H100 against the three 6-bit passes with
// lane-owned counts they replaced, the two passes take two fifths off the
// sort phase and a sixth to a quarter off the kernel; peers from
// __match_any_sync, a count sweep by the lowest peer instead of atomics and
// 512 threads were slower (scripts/match_variants.py; PERF.md §6).
// The rest is the word build
// (hashing: byte loads of the staged block; kPasses = 0 leaves it alone), the
// lag planes (2 bytes per position and rung, L2-resident), the 64 KB halves'
// key-indexed lookups (two dependent device-memory loads where a second-half
// position is first of its key) and the extensions. Counting the next pass's
// digits during a scatter and several small blocks per CTA are left for
// later.
//
// Traced (kTrace, trace.cuh): thread 0 reads clock64() after the barriers that
// end each phase and adds the cycles since its last reading to the phase's
// counter of the launch's record: c[0] stage (stage_row, every chunk's and
// the selection's), c[1] sort (the word build and the radix passes), c[2] lags
// (the predecessor sweep with the 64 KB halves' lookup, and the plane write),
// c[3] select (selection and extensions), c[4] fold (the neighbor fold and
// the write-out, to thread 0's own end: no barrier follows it), c[5] the
// CTA's cycles from its start. Every boundary is an existing barrier, so no
// phases are merged. In a split rung's second half each warp's lane 0 also
// reads clock() around the lookup of every warp-step in which some lane
// looks up, after the warp's lanes meet at a ballot on each side, and the
// warp adds those cycles to c[6], its lookups to c[7] and those that found a
// first-half word to c[8], once a chunk. Each CTA also folds its
// %globaltimer span in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix.cuh"
#include "staging.cuh"
#include "trace.cuh"

namespace {

constexpr uint32_t kM1 = 0x9E3779B1u;  // lane_model_encode.py:183-184
constexpr uint32_t kM2 = 0x85EBCA77u;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kHalf = 32768;  // rows sorted at once in shared memory
constexpr int kMaxBlockSize = 2 * kHalf;
constexpr int kPad = 64;  // the longest rung's window
constexpr int kMaxThreads = 1024;
constexpr int kSteps = kHalf / kMaxThreads;  // most rows a thread walks in a pass
constexpr int kHeld = 32;  // of them held in registers; any rest parked in shared memory
constexpr int kBins = 512;                   // digits of at most 9 bits
constexpr int kPasses = 2;                   // 9+8 or 8+8 bits of key
constexpr int kMatchAny = 0;                 // peers: 1 __match_any_sync, 0 the digit's ballots
constexpr int kMaxPrevK = 8;
constexpr int kMinWindow = 512;
constexpr size_t kMaxSharedBytes = 232448;  // per-block limit on sm_90

enum Mode { kRungPick = 0, kSelectAll = 1, kLadder = 2 };

__host__ __device__ inline int sort_size(int n) {
  int m = 2;
  while (m < n) m <<= 1;
  return m;
}

__host__ __device__ inline int sort_rows(int bs) {
  const int n = sort_size(bs);
  return n < kHalf ? n : kHalf;
}

// Threads of the CTA: half the sort rows, whole warps, at most 1024.
__host__ __device__ inline int block_threads(int bs) {
  const int half = sort_rows(bs) / 2;
  return half < 32 ? 32 : (half < kMaxThreads ? half : kMaxThreads);
}

// Sort words: every chunk's rows rounded up to whole thread-steps.
__host__ __device__ inline int buffer_words(int bs) {
  const int rows = sort_rows(bs), steps = 2 * block_threads(bs);
  return rows > steps ? rows : steps;
}

// The first region: the block's bytes, or during a rung's sort the words
// parked there (4 (kSteps - kHeld) threads bytes) and the lags by row (2 per
// row), both at most 2 * buffer_words(bs) bytes.
__host__ __device__ inline int region_bytes(int bs) {
  const int bytes = pim::round16(bs + kPad), sort = 2 * buffer_words(bs);
  return bytes > sort ? bytes : sort;
}

__host__ __device__ inline size_t shared_bytes(int bs) {
  return static_cast<size_t>(region_bytes(bs)) + 4u * buffer_words(bs) +
         4u * (kBins / 2) * (block_threads(bs) / 32 + 1) + 4u * 32;
}

// log2 of the stride of the rung 4 << bit: 2 bits per rung. Strides are
// powers of two, so a rung's sizes below are shifts: kept cheap to recompute,
// they cost the sort no registers (divisions by the stride were kept live
// across it and spilled one).
__host__ __device__ inline int rung_shift(int stride_code, int bit) {
  return (stride_code >> (2 * bit)) & 3;
}

// A rung's rows in the block padded to its power-of-two sort size.
__host__ __device__ inline int padded_rows(int bs, int shift) {
  const int rows = sort_size(bs) >> shift;
  return rows > 1 ? rows : 1;
}

// Rows of a rung's window group: window / stride, or all its padded rows.
__host__ __device__ inline int group_rows(int bs, int shift, int window) {
  const int rows = padded_rows(bs, shift);
  return (window > 0 && (window >> shift) < rows) ? window >> shift : rows;
}

__device__ __forceinline__ uint32_t word4(const uint8_t* s, int q) {
  return s[q] | (static_cast<uint32_t>(s[q + 1]) << 8) |
         (static_cast<uint32_t>(s[q + 2]) << 16) | (static_cast<uint32_t>(s[q + 3]) << 24);
}

// h_L[p] of the spec's hash ladder (lane_model_encode._hash_ladder_step):
// h_4 = W4, h_2s[p] = h_s[p]*M1 ^ h_s[p+s]*M2, all mod 2^32. A level-s hash
// at p + s past the block is 0 in the spec; computed from the zero pad it is
// 0 too (0*M1 ^ 0*M2), so the tree below over L/4 words is the spec exactly.
template <int L>
__device__ __forceinline__ uint32_t rung_hash(const uint8_t* s, int p) {
  uint32_t v[L / 4];
#pragma unroll
  for (int i = 0; i < L / 4; ++i) v[i] = word4(s, p + 4 * i);
#pragma unroll
  for (int n = L / 4; n > 1; n >>= 1) {
#pragma unroll
    for (int i = 0; i < n / 2; ++i) v[i] = v[2 * i] * kM1 ^ v[2 * i + 1] * kM2;
  }
  return v[0];
}

__device__ __forceinline__ uint32_t hash_at(const uint8_t* s, int p, int rung) {
  switch (rung) {
    case 4: return rung_hash<4>(s, p);
    case 8: return rung_hash<8>(s, p);
    case 16: return rung_hash<16>(s, p);
    case 32: return rung_hash<32>(s, p);
    default: return rung_hash<64>(s, p);
  }
}

// Stable LSD radix sort of the words w[0, steps * nt) on bits [pos_bits, 32),
// by the whole CTA; warp k owns words [k * 32 * steps, (k + 1) * 32 * steps).
// A thread holds its first kHeld words of a pass in registers and parks the
// rest in `parked` ((steps - kHeld) * nt words) between the sweeps. hist holds
// each warp's column of digit counts (wide_slot), (kBins / 2) x (nw + 1) words.
__device__ void radix_sort(uint32_t* words, uint32_t* parked, uint32_t* hist, uint32_t* tot, int steps,
                           int pos_bits, int tid, int nt) {
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const uint32_t lt = (1u << lane) - 1;  // lanemask_lt
  const uint32_t* slice = words + warp * 32 * steps + lane;
  uint32_t* column = hist + warp;  // this warp's counts, then its running offsets
  uint16_t* column16 = reinterpret_cast<uint16_t*>(column);
  for (int pass = 0, shift = pos_bits; pass < kPasses; ++pass) {
    const int bits = (pass == 0 && pos_bits == 15) ? 9 : 8;  // 9+8 or 8+8
    const uint32_t digit = (1u << bits) - 1;
    for (int j = lane; j < (1 << bits) / 2; j += 32) column[j * (nw + 1)] = 0;
    __syncwarp();
    uint32_t w[kHeld];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < steps) {
        const uint32_t x = slice[32 * i];
        if (i < kHeld) {
          w[i] = x;
        } else {
          parked[(i - kHeld) * nt + tid] = x;
        }
        const uint32_t d = (x >> shift) & digit;
        atomicAdd(column + (d >> 1) * (nw + 1), 1u << ((d & 1) << 4));
      }
    }
    __syncthreads();
    pim::scan_wide_counts(hist, tot, bits, tid, nt);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < steps) {
        const uint32_t x = i < kHeld ? w[i] : parked[(i - kHeld) * nt + tid];
        const uint32_t d = (x >> shift) & digit;
        const uint32_t peers = pim::peers_of<kMatchAny != 0>(d, bits);
        const uint32_t rank = __popc(peers & lt);
        uint16_t* h = column16 + pim::wide_slot(d, nw);  // the digit's running offset in this warp
        const uint32_t base = *h;
        words[base + rank] = x;
        __syncwarp();  // every peer has read the offset
        if (rank == 0) *h = static_cast<uint16_t>(base + __popc(peers));
        __syncwarp();  // the next step reads it
      }
    }
    __syncthreads();
    shift += bits;
  }
}

// The row of the last word with the 16-bit key `key` in a split rung's sorted
// first half fh, or -1: the index in the key's slot of last_idx, held to the
// word it points at (a slot of a key absent from the first half is stale).
__device__ __forceinline__ int last_with_key(const uint32_t* fh, const uint16_t* last_idx, uint32_t key) {
  const uint32_t w = fh[last_idx[key] & (kHalf - 1)];
  return (w >> 16) == key ? static_cast<int>(w & 0xFFFFu) : -1;
}

// The 4 bytes at s[q, q + 4), little-endian, from two aligned 32-bit loads.
__device__ __forceinline__ uint32_t load4(const uint8_t* s, int q) {
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s);
  return __funnelshift_r(s32[q >> 2], s32[(q >> 2) + 1], (q & 3) * 8);
}

// Leading equal bytes of p and p - lag, at most cap; kept only from 4 up.
// Reads stay below p + cap + 7 <= len + 7, inside the 64-byte zero pad.
__device__ __forceinline__ int extend(const uint8_t* s, int p, int lag, int cap) {
  if (lag <= 0) return 0;
  int n = 0;
  while (n < cap) {
    const uint32_t x = load4(s, p + n) ^ load4(s, p - lag + n);
    if (x) {
      n += (__ffs(x) - 1) >> 3;
      break;
    }
    n += 4;
  }
  n = min(n, cap);
  return n < 4 ? 0 : n;
}

enum Phase { kStage = 0, kSort = 1, kLags = 2, kSelect = 3, kFold = 4, kTotal = 5 };
enum LookupCounter { kLookupCycles = 6, kLookups = 7, kHits = 8 };

// The lag sweep of a split rung's second half (stride 1, 16-bit keys, one
// window group): a row's sorted predecessor with its key, or, for a row first
// of its key in its half, the first half's last word with the key. Traced:
// each warp's lane 0 reads clock() around the lookup of every warp-step in
// which some lane looks up, after a ballot on each side, and the warp adds
// those cycles, its lookups and its hits to c[6], c[7] and c[8] once. Its own
// loop, apart from the other sweeps': there the traced kernel's code stays as
// the plain one's (timing inside the shared loop slowed the whole traced
// kernel by 5 %, its sort too, on an H100).
template <bool kTrace>
__device__ __forceinline__ void second_half_lags(const uint32_t* s_words, uint16_t* s_near, const uint32_t* fh,
                                                 const uint16_t* table, int real, int r0, int tid, int nt,
                                                 pim::TraceRecord* trace) {
  [[maybe_unused]] const int lane = tid & 31;
  [[maybe_unused]] uint32_t cycles = 0, counts = 0;  // lane 0's: the lookup's cycles; lookups | hits << 16
  for (int i = tid; i < real; i += nt) {
    const uint32_t w = s_words[i];
    const uint32_t key = w >> 16;
    const int row = static_cast<int>(w & 0xFFFFu);
    const bool look = i == 0 || (s_words[i - 1] >> 16) != key;
    int prev = look ? -1 : static_cast<int>(s_words[i - 1] & 0xFFFFu);
    if constexpr (kTrace) {
      const int n = real - (i - lane);  // the lanes of this step are a prefix of the warp
      const uint32_t mask = n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1;
      const uint32_t lookers = __ballot_sync(mask, look);
      const uint32_t t0 = clock();
      if (look) prev = last_with_key(fh, table, key);
      const uint32_t hits = __ballot_sync(mask, prev >= 0) & lookers;  // after every lane's loads
      if (lane == 0 && lookers) {
        cycles += clock() - t0;
        counts += __popc(lookers) | (__popc(hits) << 16);  // at most 1024 each: 32 steps a warp
      }
    } else if (look) {
      prev = last_with_key(fh, table, key);
    }
    s_near[row - r0] = static_cast<uint16_t>(prev >= 0 ? row - prev : 0);
  }
  if constexpr (kTrace) {
    if (counts) {
      atomicAdd(&trace->c[kLookupCycles], static_cast<unsigned long long>(cycles));
      atomicAdd(&trace->c[kLookups], static_cast<unsigned long long>(counts & 0xFFFFu));
      atomicAdd(&trace->c[kHits], static_cast<unsigned long long>(counts >> 16));
    }
  }
}

// Traced: thread 0 adds the cycles since its last reading to `phase`.
template <bool kTrace>
__device__ __forceinline__ void phase_end(pim::TraceRecord* trace, long long& last, Phase phase, int tid) {
  if constexpr (kTrace) {
    if (tid == 0) {
      const long long now = clock64();
      atomicAdd(&trace->c[phase], static_cast<unsigned long long>(now - last));
      last = now;
    }
  }
}

template <bool kTrace>
__global__ void __launch_bounds__(kMaxThreads)
match_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                    uint8_t* __restrict__ mlen, uint16_t* __restrict__ mlag,
                    uint16_t* __restrict__ near, uint32_t* __restrict__ first_half,
                    uint16_t* __restrict__ last_idx, int bs,
                    int rung_mask, int ext_cap, int neighbor, int max_lag, int prev_k,
                    int sel_cap, int mode, int stride_code, int window, pim::TraceRecord* trace) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nt = blockDim.x;
  uint8_t* s_bytes = smem;  // region_bytes(bs): the bytes, or parked words and lags by row
  uint32_t* s_parked = reinterpret_cast<uint32_t*>(smem);
  uint16_t* s_near = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + region_bytes(bs));  // buffer_words(bs)
  uint32_t* s_hist = s_words + buffer_words(bs);                  // (kBins / 2) * (warps + 1)
  uint32_t* s_tot = s_hist + (kBins / 2) * ((nt >> 5) + 1);      // 32

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = min(max(lens[b], 0), bs);
  const size_t row_base = static_cast<size_t>(b) * bs;
  const int n_rungs = __popc(rung_mask);
  uint16_t* planes = near + static_cast<size_t>(b) * n_rungs * bs;  // [n_rungs][bs]
  uint32_t* fh = first_half + static_cast<size_t>(b) * kHalf;        // used by a split sort
  // Traced: thread 0's last clock64() reading, in shared memory so that it
  // takes no register across the sort. The total's counter takes -start now
  // and the end at the end, as trace_start does for the span.
  [[maybe_unused]] __shared__ long long last;
  if constexpr (kTrace) {
    if (tid == 0) {
      pim::trace_start(trace, pim::globaltimer());
      last = clock64();
      atomicAdd(&trace->c[kTotal], 0ull - static_cast<unsigned long long>(last));
    }
  }

  // Nearest previous equal key per rung, uncapped, into the lag planes. The
  // bytes are staged anew for each chunk: its sort reuses their region.
  for (int bit = 0, ri = 0; bit < 5; ++bit) {
    if (!(rung_mask & (1 << bit))) continue;
    const int rung = 4 << bit;
    const int sh = rung_shift(stride_code, bit);
    const int stride = 1 << sh;
    const int rows_pad = padded_rows(bs, sh);
    const int pos_bits = rows_pad > kHalf ? 16 : 15;
    const uint32_t pos_mask = (1u << pos_bits) - 1;
    const uint32_t key_mask = (1u << (32 - pos_bits)) - 1;
    const int cnt = (bs + stride - 1) >> sh;  // real rows
    const int group = group_rows(bs, sh, window);
    const int chunk = min(kHalf, rows_pad);  // rows sorted at once
    const bool split = group > chunk;        // stride 1, no window, above 32768 rows
    uint16_t* plane = planes + static_cast<size_t>(ri++) * bs;
    for (int r0 = 0; r0 < cnt; r0 += chunk) {
      const int real = min(chunk, cnt - r0);
      const int steps = (real + nt - 1) / nt;  // at most kSteps
      pim::stage_row(s_bytes, blocks + row_base, len, pim::round16(bs + kPad), tid, nt);
      __syncthreads();
      phase_end<kTrace>(trace, last, kStage, tid);
      for (int i = tid; i < steps * nt; i += nt) {
        uint32_t w = kSentinel;
        if (i < real) {
          const int row = r0 + i;
          const uint32_t h = hash_at(s_bytes, row * stride, rung);
          w = (((h ^ (h >> pos_bits)) & key_mask) << pos_bits) | static_cast<uint32_t>(row);
        }
        s_words[i] = w;
      }
      __syncthreads();
      radix_sort(s_words, s_parked, s_hist, s_tot, steps, pos_bits, tid, nt);
      phase_end<kTrace>(trace, last, kSort, tid);
      // Sorted slots [0, real) hold the real words; equal keys sit in row order.
      uint16_t* table = last_idx + static_cast<size_t>(b) * (1 << 16);  // used by a split sort
      if (split && r0 > 0) {
        second_half_lags<kTrace>(s_words, s_near, fh, table, real, r0, tid, nt, trace);
      } else {
        for (int i = tid; i < real; i += nt) {
          const uint32_t w = s_words[i];
          const uint32_t key = w >> pos_bits;
          const int row = static_cast<int>(w & pos_mask);
          int prev = -1;
          if (i > 0 && (s_words[i - 1] >> pos_bits) == key) {
            prev = static_cast<int>(s_words[i - 1] & pos_mask);
            if (prev / group != row / group) prev = -1;  // before the row's window group
          }
          s_near[row - r0] = static_cast<uint16_t>(prev >= 0 ? (row - prev) * stride : 0);
          if (split) {  // the first half: its sorted words, and each key's last index
            fh[i] = w;
            if (i == real - 1 || (s_words[i + 1] >> pos_bits) != key) table[key] = static_cast<uint16_t>(i);
          }
        }
      }
      __syncthreads();
      const int p0 = r0 * stride, p1 = min(bs, (r0 + real) * stride);
      for (int p = p0 + tid; p < p1; p += nt) {
        plane[p] = (p - p0) % stride ? 0 : s_near[(p - p0) / stride];
      }
      __syncthreads();
      phase_end<kTrace>(trace, last, kLags, tid);
    }
  }
  pim::stage_row(s_bytes, blocks + row_base, len, pim::round16(bs + kPad), tid, nt);
  __syncthreads();
  phase_end<kTrace>(trace, last, kStage, tid);

  // Selection and the winner's extension, per position; the pre-fold lag
  // goes to shared memory (the sort buffer is free) and the length out.
  uint16_t* s_lag = reinterpret_cast<uint16_t*>(s_words);
  for (int p = tid; p < bs; p += nt) {
    const int room = len - p;
    int sel = 0, sel_len = 0;    // rung pick, select: the candidate to extend
    int best = 0, best_len = 0;  // the match; the per-rung ladder folds into it
    for (int bit = 0, ri = 0; bit < 5; ++bit) {
      if (!(rung_mask & (1 << bit))) continue;
      const uint16_t* plane = planes + static_cast<size_t>(ri++) * bs;
      const int steps = (mode != kRungPick && bit == 0) ? prev_k : 1;
      const bool cheap = mode == kLadder && bit == 0 && prev_k > 1 && sel_cap > 0;
      int pick = 0, pick_len = 0;  // the ladder's capped select on the 4-byte rung
      int lag = plane[p];
      for (int j = 1; j <= steps; ++j) {
        if (j > 1 && lag > 0) {  // lag composition on the uncapped chain
          const int more = plane[p - lag];
          lag = more > 0 ? lag + more : 0;
        }
        const int cand = (max_lag > 0 && lag > max_lag) ? 0 : lag;
        if (mode == kRungPick) {  // a later, longer rung overrides
          if (cand > 0) sel = cand;
        } else if (mode == kSelectAll) {
          const int n = extend(s_bytes, p, cand, min(sel_cap, room));
          if (n > sel_len) {
            sel_len = n;
            sel = cand;
          }
        } else if (cheap) {
          const int n = extend(s_bytes, p, cand, min(sel_cap, room));
          if (n > pick_len) {
            pick_len = n;
            pick = cand;
          }
        } else {
          const int n = extend(s_bytes, p, cand, min(ext_cap, room));
          if (n > best_len) {
            best_len = n;
            best = cand;
          }
        }
      }
      if (cheap) {
        const int n = extend(s_bytes, p, pick, min(ext_cap, room));
        if (n > best_len) {
          best_len = n;
          best = pick;
        }
      }
    }
    if (mode != kLadder) {
      best_len = extend(s_bytes, p, sel, min(ext_cap, room));
      best = best_len > 0 ? sel : 0;
    }
    s_lag[p] = static_cast<uint16_t>(best);
    mlen[row_base + p] = static_cast<uint8_t>(best_len);
  }
  __syncthreads();
  phase_end<kTrace>(trace, last, kSelect, tid);
  uint8_t* s_len = s_bytes;  // the bytes are no longer read
  for (int p = tid; p < bs; p += nt) s_len[p] = mlen[row_base + p];
  __syncthreads();

  // Neighbor fold (derive_neighbor): take p-1's match one byte shorter when
  // it is at least 4 and strictly longer than p's own.
  for (int p = tid; p < bs; p += nt) {
    int n = s_len[p];
    int lag = s_lag[p];
    if (neighbor && p > 0) {
      const int inherited = static_cast<int>(s_len[p - 1]) - 1;
      if (inherited >= 4 && inherited > n) {
        n = inherited;
        lag = s_lag[p - 1];
      }
    }
    mlen[row_base + p] = static_cast<uint8_t>(n);
    mlag[row_base + p] = static_cast<uint16_t>(lag);
  }
  phase_end<kTrace>(trace, last, kFold, tid);
  if constexpr (kTrace) {
    if (tid == 0) {
      atomicAdd(&trace->c[kTotal], static_cast<unsigned long long>(last));
      pim::trace_end(trace, pim::globaltimer());
    }
  }
}

template <bool kTrace>
cudaError_t launch(const void* blocks, const void* lens, void* mlen, void* mlag, void* near, void* first_half,
                   void* last_idx, int num_blocks, int block_size, int rung_mask, int ext_cap, int neighbor,
                   int max_lag, int prev_k, int sel_cap, int mode, int stride_code, int window, void* stream,
                   void* trace) {
  const size_t smem = shared_bytes(block_size);
  const int threads = block_threads(block_size);
  const cudaError_t st = cudaFuncSetAttribute(match_blocks_kernel<kTrace>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (st != cudaSuccess) return st;
  match_blocks_kernel<kTrace><<<num_blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(mlen), static_cast<uint16_t*>(mlag), static_cast<uint16_t*>(near),
      static_cast<uint32_t*>(first_half), static_cast<uint16_t*>(last_idx), block_size, rung_mask, ext_cap,
      neighbor, max_lag, prev_k, sel_cap, mode, stride_code, window, static_cast<pim::TraceRecord*>(trace));
  return cudaGetLastError();
}

}  // namespace

// Match num_blocks blocks on `stream`. blocks is uint8[num_blocks, block_size],
// lens int32[num_blocks]; mlen uint8 and mlag uint16 (an int16 tensor's bits)
// are [num_blocks, block_size]. near is uint16[num_blocks, n_rungs, block_size]
// scratch; first_half is uint32[num_blocks, 32768] and last_idx
// uint16[num_blocks, 65536] scratch when some rung sorts more than 32768 rows
// in one group (stride 1, no window, block_size > 32768; else unused, may be
// null); neither needs clearing. rung_mask bit i selects rung 4 << i; stride_code
// bits 2i..2i+1 hold log2 of its stride (the 4-byte rung's must be 0); window
// is the sort window in bytes (0 = none; else a power of two >= 512 that
// divides the block's power-of-two sort size). max_lag 0 means no cap. mode 0
// is the rung pick (prev_k 1, sel_cap 0), 1 the select ladder (sel_cap > 0),
// 2 the per-rung ladder; modes 1 and 2 take prev_k candidates on the 4-byte
// rung. trace is a zeroed pim::TraceRecord on the device for the traced
// kernel, or null for the plain one. Returns cudaGetLastError() after the
// launch (0 on success). Does not synchronise.
extern "C" int pim_match_blocks(const void* blocks, const void* lens, void* mlen, void* mlag,
                                void* near, void* first_half, void* last_idx, int num_blocks, int block_size,
                                int rung_mask, int ext_cap, int neighbor, int max_lag,
                                int prev_k, int sel_cap, int mode, int stride_code, int window,
                                int device, void* stream, void* trace) {
  if (num_blocks <= 0) return 0;
  if (block_size <= 0 || block_size > kMaxBlockSize || rung_mask <= 0 || rung_mask >= 32 ||
      ext_cap < 4 || ext_cap > 64 || (ext_cap & 3) || max_lag < 0 || prev_k < 1 ||
      prev_k > kMaxPrevK || sel_cap < 0 || sel_cap > ext_cap || (sel_cap & 3) || mode < 0 ||
      mode > kLadder || (mode == kRungPick && (prev_k != 1 || sel_cap != 0)) ||
      (mode == kSelectAll && sel_cap == 0) || stride_code < 0 || stride_code >= (1 << 10) ||
      ((rung_mask & 1) && (stride_code & 3)) || window < 0 ||
      (window > 0 && ((window & (window - 1)) || window < kMinWindow ||
                      window > sort_size(block_size))) ||
      near == nullptr)
    return cudaErrorInvalidValue;
  bool split = false;  // some rung sorts its 32 KB halves in turn
  for (int bit = 0; bit < 5; ++bit) {
    if (rung_mask & (1 << bit)) {
      split = split || group_rows(block_size, rung_shift(stride_code, bit), window) > kHalf;
    }
  }
  if (split && (first_half == nullptr || last_idx == nullptr)) return cudaErrorInvalidValue;
  if (shared_bytes(block_size) > kMaxSharedBytes) return cudaErrorInvalidValue;
  const cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  return static_cast<int>(
      trace ? launch<true>(blocks, lens, mlen, mlag, near, first_half, last_idx, num_blocks, block_size, rung_mask,
                           ext_cap, neighbor, max_lag, prev_k, sel_cap, mode, stride_code, window, stream, trace)
            : launch<false>(blocks, lens, mlen, mlag, near, first_half, last_idx, num_blocks, block_size, rung_mask,
                            ext_cap, neighbor, max_lag, prev_k, sel_cap, mode, stride_code, window, stream, trace));
}
