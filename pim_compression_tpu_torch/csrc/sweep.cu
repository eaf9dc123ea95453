// The sweep matcher of the block-parallel modified-Snappy encoder, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package and the XLA glue around them:
//   pim_compression_tpu/ops/pallas_encode.py::_match_kernel    every lag in [1, window]
//       and, sampled, every 8th lag in (window, coarse], by shifted compares and
//       AND-doubling over int32 [bs + 64, 128] planes of 128 blocks
//   pim_compression_tpu/ops/pallas_encode.py::_granule_kernel  every lag in
//       (window, coarse] at 8-byte-aligned positions, as exact 8-byte granule
//       equality over 8 strided phase planes
//   the glue in encode_blocks_pallas: the padded and valid planes, _granule_planes,
//       the upsample of granule scores and the packed-max merge
// Its output equals lane_model_encode.match_search (sampled) and
// match_search_granular (granular) on every position, and the plain PyTorch
// transcription hopper_sweep.sweep_match_torch.
//
// What it computes. At position p and lag d the candidate is the exact byte
// run from p at lag d, cut at the block's length and capped at 64, bucketed
// to the largest of {4, 8, 16, 32, 64} it reaches; the fold keeps the
// maximum of (length << 16) | (0xFFFF - d): longest, then nearest. A granule
// match of G consecutive 8-byte granules from p = 8i at lag d is the same
// thing as a byte run >= 8G from p (the granules lie inside the block), so
// the granular search is the same run measure at p % 8 == 0 over the lags
// in (window, coarse], counted from 2 words on. The TPU's 32 static
// sub-shifts per lag chunk, its whole-plane AND-doubling and its 8 phase
// planes exist because a TPU lane has no random access; a Hopper thread
// reads shared memory at any address, so none of them is carried over.
//
// Design: one CTA of kThreads = 1024 threads per block (bs <= 16384), in
// three steps, the kernel a template of the mode (fine, sampled, granular).
// 1. Words and keys. The block's bytes are staged (zero at and past lens[b])
//    and turned into a plane of 4-byte little-endian words W[p] = bytes
//    p..p+3. A run is counted in words: W[p + 4k] == W[p - d + 4k] for k = 0,
//    1, ... while p + 4(k+1) <= len, at most 16 words; k words give the
//    bucket of 4k bytes. Each position's key is the top kKeyBits = 12 bits
//    of W[p] * kHashMul, all ones (a sentinel) where p + 4 > len.
// 2. The table: the words (key << 14) | p of the n = round_up(bs, kThreads)
//    positions, ranked by a stable LSD radix sort of the key field, two
//    passes of 6 bits (radix.cuh: each warp owns a contiguous slice, counts
//    its digits from warp ballots, one scan digit-major and warp-minor, a
//    scatter to each digit's running offset), from one buffer to another.
//    Positions with equal keys then lie together in ascending p, so the
//    entries below a position's rank, read downwards, are the earlier
//    positions with its key, nearest first. The rank of every position is
//    kept as uint16 in the buffer the last pass read. A third pass (18-bit
//    keys) cost more than the collisions it saves on text.
// 3. The walk. Thread tid owns positions p = tid + kThreads i; with 4 bytes
//    left it walks the entries below its rank while the key is its own and
//    the lag d = p - q is within its reach: window, or coarse where a coarse
//    search runs for p (every position when sampled; 8-aligned positions with
//    8 bytes left when granular); one unsigned compare against (key << 14) |
//    max(p - reach, 0) tests both. Past the window a sampled lag counts only
//    when d % 8 == 0 (window is a multiple of 32) and a granular run only
//    from 2 words on. An entry whose word differs (a key collision) is
//    skipped. An entry that passes is measured: one compare of the last word
//    a run needs to beat the best so far rejects most, then the run's words
//    are counted, four pairs loaded at once; a longer bucket replaces the
//    best. Lags ascend along the walk, so once the bucket is the longest the
//    position's remaining length allows (64, or less near the end of the
//    block) no later entry beats it in the packed max, and the walk ends:
//    the exact early exit. The next entry is loaded a step ahead.
//    A warp waits for its longest walk, so a lane walks at most kBudget = 8
//    entries. A position still open then goes to its warp (a ballot), which
//    walks the rest of its chain 32 entries a round, one a lane, each lane's
//    reject against the best at the round's start, and folds the packed
//    candidates with __reduce_max_sync; the position ends after the round in
//    which an entry left the chain or the reach, or the best reached the top.
//    Every entry of a round is farther than every entry folded before it, so
//    the packed max gives "longest, then nearest" in any lane order.
//
// Shared memory: W, the sort's two buffers (the staged bytes live in the
// second until the sort starts; the ranks in the one the last pass read),
// 4 n bytes each, and the digit counts (4 KB) and scan totals: 102528 bytes
// at bs 8192, so two CTAs (64 warps) an SM, their registers capped at 32 a
// thread for it; 200832 at 16384, one.
//
// What bounds it: the walk's shared-memory loads at random addresses (bank
// conflicts) and their latency chains, and integer issue. On an H100 a
// 1024-block 8 KB batch of text takes about 1.07 ms (granular 2048 / 8192),
// of which about 0.2 ms is the fixed part (staging, words, the sort, the
// ranks: a batch of zeros, whose walks end at their first entry); the walk
// visits ~23 entries a position on text against the 2,080 lags an
// exhaustive sweep visits, and a warp takes ~33 steps (a lane's step or a
// round) for its 32 positions, ~90 without the handoff (the NumPy mirror,
// utils/sweep_table.py). Inputs and outputs are 4 bytes per position, so
// device memory is not the limit. 512 threads, budgets of 4, 16 and 32,
// no handoff and 18-bit keys were slower (scripts/sweep_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix.cuh"
#include "staging.cuh"

namespace {

constexpr int kMaxBlockSize = 16384;  // pallas_encode.py:47, MAX_SWEEP_BLOCK
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 2;  // the two CTAs that fit at 8 KB fit by registers too: 32 a thread
constexpr int kPosBits = 14;  // positions below 16384
constexpr uint32_t kPosMask = (1u << kPosBits) - 1;
constexpr int kDigitBits = 6;
constexpr int kPasses = 2;
constexpr int kKeyBits = kPasses * kDigitBits;  // the hash's top bits, sorted a digit a pass
constexpr uint32_t kSentinelKey = (1u << kKeyBits) - 1;
constexpr int kBins = 1 << kDigitBits;
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr int kBudget = 8;  // entries a lane walks before its warp takes the rest
constexpr int kMaxWords = 16;  // a 64-byte run
constexpr int kCoarseStep = 8;  // the sampled coarse sweep's lag stride
constexpr size_t kMaxSharedBytes = 232448;  // per-block limit on sm_90

static_assert(kPosBits + kKeyBits <= 32, "a key and a position fit a word");
static_assert(kBins * kWarps == 2 * kThreads, "scan_counts takes one pair of counts a thread");
static_assert((kMaxBlockSize + kThreads - 1) / kThreads * kThreads <= (1 << kPosBits), "positions fit");

__host__ __device__ inline int table_rows(int bs) { return (bs + kThreads - 1) / kThreads * kThreads; }

size_t shared_bytes(int bs) { return 12 * static_cast<size_t>(table_rows(bs)) + 2 * kBins * kWarps + 4 * 32; }

// The bucketed length of a run of k whole matching words.
__device__ __forceinline__ int bucket(int k) {
  return k >= 16 ? 64 : k >= 8 ? 32 : k >= 4 ? 16 : k >= 2 ? 8 : k >= 1 ? 4 : 0;
}

// Whole matching words from p at lag d, given that the first word matches:
// at most maxk, the words that fit before the block's length. Four pairs of
// words are loaded at once, so a long run waits for 4 load latencies, not
// 15; a word past maxk (at most 3 words past the length, inside the shared
// memory that follows W) decides nothing.
__device__ __forceinline__ int run_words(const uint32_t* w, int p, int d, int maxk) {
  for (int k = 1; k < maxk; k += 4) {
    uint32_t x[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = w[p + 4 * (k + j)];
      y[j] = w[p - d + 4 * (k + j)];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x[j] != y[j]) return min(k + j, maxk);
    }
  }
  return maxk;
}

// Whole words a run needs for a bucket longer than best_len (at least
// floor): 4 bytes -> 2 words, 8 -> 4, 16 -> 8, 32 -> 16.
__device__ __forceinline__ int words_to_beat(int best_len, int floor) {
  return max(floor, best_len >> 1);
}

// The bucket of the run from p at lag d if it may beat best_len, else 0 (a
// bucket at most best_len may come back too): the last word a beating run
// needs must match before the run is counted, and the run needs at least
// floor words.
__device__ __forceinline__ int measure(const uint32_t* w, int p, int d, int maxk, int best_len, int floor) {
  const int need = words_to_beat(best_len, floor) - 1;
  if (w[p - d + 4 * need] != w[p + 4 * need]) return 0;
  const int k = run_words(w, p, d, maxk);
  return k >= floor ? bucket(k) : 0;
}

enum Mode { kFine = 0, kSampled = 1, kGranular = 2 };

// What a walk finds in table entry e: the lag, whether the chain or the reach
// ended there, and whether the entry is a candidate (not a sampled lag off
// the stride, not a key collision). The entries below a position's rank are
// smaller than its own (key << kPosBits) | p, so they have its key and a
// lag within its reach exactly when they are at least lo = (key <<
// kPosBits) | max(p - reach, 0): one compare ends the walk.
struct Entry {
  int d;
  bool end, cand;
};

template <int kMode>
__device__ __forceinline__ Entry look(uint32_t e, bool in_table, const uint32_t* w, int p, uint32_t lo,
                                      uint32_t w0, int window) {
  if (!in_table || e < lo) return {0, true, false};
  const int d = p - static_cast<int>(e & kPosMask);
  if (kMode == kSampled && d > window && (d & (kCoarseStep - 1))) return {d, false, false};
  return {d, false, w[p - d] == w0};
}

__device__ __forceinline__ void put(uint8_t* mlen, uint16_t* mlag, size_t at, int best) {
  const int len = best >> 16;
  mlen[at] = static_cast<uint8_t>(len);
  mlag[at] = len ? static_cast<uint16_t>(0xFFFF - (best & 0xFFFF)) : 0;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    sweep_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                        uint8_t* __restrict__ mlen, uint16_t* __restrict__ mlag, int bs, int window,
                        int coarse) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n = table_rows(bs);
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  uint32_t* src = w + n;    // the words in position order, then every other pass's output
  uint32_t* dst = src + n;  // the staged bytes, then the other passes' output
  uint16_t* hist = reinterpret_cast<uint16_t*>(dst + n);  // kBins x kWarps digit counts
  uint32_t* tot = reinterpret_cast<uint32_t*>(hist + kBins * kWarps);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lens[b], 0), bs);
  const size_t row = static_cast<size_t>(b) * bs;

  // 1. Words and keys.
  const uint8_t* s_data = reinterpret_cast<uint8_t*>(dst);
  pim::stage_row(reinterpret_cast<uint8_t*>(dst), blocks + row, len, pim::round16(bs), tid, kThreads);
  __syncthreads();
  for (int p = tid; p < n; p += kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k) v = (v << 8) | (p + k < bs ? s_data[p + k] : 0u);
    w[p] = v;
    const uint32_t key = p + 4 <= len ? (v * kHashMul) >> (32 - kKeyBits) : kSentinelKey;
    src[p] = (key << kPosBits) | static_cast<uint32_t>(p);
  }
  __syncthreads();

  // 2. The table: a stable radix sort of the key field, then each position's rank.
  const int steps = n / kThreads;  // words a lane takes in a sweep
  const uint32_t lt = (1u << lane) - 1;  // lanemask_lt
  for (int pass = 0, shift = kPosBits; pass < kPasses; ++pass, shift += kDigitBits) {
    const uint32_t* slice = src + warp * 32 * steps + lane;
    uint32_t c_lo = 0, c_hi = 0;  // words of digit lane and lane + 32 in this warp's slice
    for (int i = 0; i < steps; ++i) {
      const pim::Split sp = pim::multisplit(slice[32 * i], shift, kDigitBits, lane);
      c_lo += __popc(sp.own_lo);
      c_hi += __popc(sp.own_hi);
    }
    hist[lane * kWarps + warp] = static_cast<uint16_t>(c_lo);
    hist[(lane + 32) * kWarps + warp] = static_cast<uint16_t>(c_hi);
    __syncthreads();
    pim::scan_counts(hist, tot, tid, kThreads);
    __syncthreads();
    uint32_t run_lo = hist[lane * kWarps + warp], run_hi = hist[(lane + 32) * kWarps + warp];
    for (int i = 0; i < steps; ++i) {
      const uint32_t x = slice[32 * i];
      const pim::Split sp = pim::multisplit(x, shift, kDigitBits, lane);
      const uint32_t lo = __shfl_sync(~0u, run_lo, sp.digit & 31);
      const uint32_t hi = __shfl_sync(~0u, run_hi, sp.digit & 31);
      dst[(sp.digit < 32 ? lo : hi) + __popc(sp.peers & lt)] = x;
      run_lo += __popc(sp.own_lo);
      run_hi += __popc(sp.own_hi);
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  const uint32_t* table = src;
  uint16_t* rank = reinterpret_cast<uint16_t*>(dst);
  for (int r = tid; r < n; r += kThreads) rank[table[r] & kPosMask] = static_cast<uint16_t>(r);
  __syncthreads();

  // 3. The walk, nearest first; a lane's first kBudget entries, then its warp's rounds.
  for (int p = tid; p < n; p += kThreads) {  // the same trip count on every lane of a warp
    const bool live = p + 4 <= len;
    uint32_t w0 = 0, lo = 0;
    int r = -1, maxk = 0, top = 0;
    if (live) {
      w0 = w[p];
      r = rank[p] - 1;
      maxk = min(kMaxWords, (len - p) >> 2);
      top = bucket(maxk);
      const bool far = kMode == kSampled || (kMode == kGranular && (p & 7) == 0 && p + 8 <= len);
      const uint32_t key = (w0 * kHashMul) >> (32 - kKeyBits);
      lo = (key << kPosBits) | static_cast<uint32_t>(max(p - (far ? coarse : window), 0));
    }
    int best_len = 0, best_d = 0;
    bool open = live;
    uint32_t next = r >= 0 ? table[r] : 0u;  // the entry at rank r, loaded a step ahead
    for (int s = 0; s < kBudget && open; ++s) {
      const uint32_t entry = next;
      const bool in_table = r-- >= 0;
      next = r >= 0 ? table[r] : 0u;
      const Entry e = look<kMode>(entry, in_table, w, p, lo, w0, window);
      if (e.end) {
        open = false;
      } else if (e.cand) {
        const int l = measure(w, p, e.d, maxk, best_len, kMode == kGranular && e.d > window ? 2 : 1);
        if (l > best_len) {
          best_len = l;
          best_d = e.d;
          open = l != top;
        }
      }
    }
    int best = best_len ? (best_len << 16) | (0xFFFF - best_d) : 0;  // (length << 16) | (0xFFFF - lag)

    // The handoff: every value in a round's loop condition is the same on all lanes.
    for (uint32_t pending = __ballot_sync(~0u, open); pending; pending &= pending - 1) {
      const int from = __ffs(pending) - 1;
      const int hp = __shfl_sync(~0u, p, from), hr = __shfl_sync(~0u, r, from);
      const int hmaxk = __shfl_sync(~0u, maxk, from), htop = __shfl_sync(~0u, top, from);
      const uint32_t hlo = __shfl_sync(~0u, lo, from), hw0 = __shfl_sync(~0u, w0, from);
      int cur = __shfl_sync(~0u, best, from);
      uint32_t next_round = hr - lane >= 0 ? table[hr - lane] : 0u;  // loaded a round ahead
      for (int r0 = hr;; r0 -= 32) {
        const uint32_t entry = next_round;
        next_round = r0 - 32 - lane >= 0 ? table[r0 - 32 - lane] : 0u;
        const Entry e = look<kMode>(entry, r0 - lane >= 0, w, hp, hlo, hw0, window);
        int cand = 0;
        if (e.cand) {
          const int l = measure(w, hp, e.d, hmaxk, cur >> 16, kMode == kGranular && e.d > window ? 2 : 1);
          if (l) cand = (l << 16) | (0xFFFF - e.d);
        }
        cur = max(cur, static_cast<int>(__reduce_max_sync(~0u, static_cast<unsigned>(cand))));
        if (__any_sync(~0u, e.end) || (cur >> 16) == htop) break;
      }
      if (lane == from) best = cur;
    }
    if (p < bs) put(mlen, mlag, row + p, best);
  }
}

// One launch of the kernel for mode kMode.
template <int kMode>
cudaError_t launch(const void* blocks, const void* lens, void* mlen, void* mlag, int num_blocks, int block_size,
                   int window, int coarse, cudaStream_t stream) {
  const size_t smem = shared_bytes(block_size);
  const cudaError_t st = cudaFuncSetAttribute(sweep_blocks_kernel<kMode>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (st != cudaSuccess) return st;
  sweep_blocks_kernel<kMode><<<num_blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens), static_cast<uint8_t*>(mlen),
      static_cast<uint16_t*>(mlag), block_size, window, coarse);
  return cudaGetLastError();
}

}  // namespace

// Sweep-match num_blocks blocks on `stream`. blocks uint8[num_blocks,
// block_size], lens int32[num_blocks]; mlen uint8 and mlag uint16 (an int16
// tensor's bits) [num_blocks, block_size]. window, coarse and granular as
// hopper_sweep.sweep_knobs normalises them (coarse 0 = no coarse search).
// Returns cudaGetLastError() after the launch (0 on success). Does not
// synchronise.
extern "C" int pim_sweep_blocks(const void* blocks, const void* lens, void* mlen, void* mlag,
                                int num_blocks, int block_size, int window, int coarse,
                                int granular, int device, void* stream) {
  if (num_blocks <= 0) return 0;
  if (block_size <= 0 || block_size > kMaxBlockSize || window < 0 || coarse < 0) {
    return cudaErrorInvalidValue;
  }
  if (shared_bytes(block_size) > kMaxSharedBytes) return cudaErrorInvalidValue;
  const cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coarse <= window) return launch<kFine>(blocks, lens, mlen, mlag, num_blocks, block_size, window, coarse, s);
  if (granular) return launch<kGranular>(blocks, lens, mlen, mlag, num_blocks, block_size, window, coarse, s);
  return launch<kSampled>(blocks, lens, mlen, mlag, num_blocks, block_size, window, coarse, s);
}

// CTAs of the sweep kernel (granular; every mode takes the same shared
// memory) that fit on one SM of `device` at block_size (CUDA's occupancy
// query), or minus a CUDA error code.
extern "C" int pim_sweep_ctas_per_sm(int block_size, int device) {
  if (block_size <= 0 || block_size > kMaxBlockSize) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes(block_size);
  cudaError_t st = cudaSetDevice(device);
  if (st == cudaSuccess) {
    st = cudaFuncSetAttribute(sweep_blocks_kernel<kGranular>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  }
  int ctas = 0;
  if (st == cudaSuccess) {
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, sweep_blocks_kernel<kGranular>, kThreads, smem);
  }
  return st == cudaSuccess ? ctas : -static_cast<int>(st);
}
