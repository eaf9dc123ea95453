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
// in (window, coarse] with the bucket floor at 8. The TPU's 32 static
// sub-shifts per lag chunk, its whole-plane AND-doubling and its 8 phase
// planes exist because a TPU lane has no random access; a Hopper thread
// reads shared memory at any address, so none of them is carried over.
//
// Design: one CTA of 512 threads per block (bs <= 16384). The block's bytes
// are staged (zero at and past lens[b]) and turned into a plane of 4-byte
// little-endian words W[p] = bytes p..p+3 in shared memory. A run is then
// counted in words: W[p + 4k] == W[p - d + 4k] for k = 0, 1, ... while
// p + 4(k+1) <= len, at most 16 words; k words give the bucket of 4k bytes
// (every bucket is a multiple of 4). One compare of W[p - d] against the
// thread's W[p] rejects most lags, and of the rest, one compare of the last
// word a run needs to beat the position's best so far rejects most before
// the run is counted (a thread that counts runs holds up its warp).
//   Fine sweep (and the sampled coarse lags): each thread owns positions,
//   visits the lags in ascending order and keeps the first lag of the
//   longest bucket, four first-word compares per loop step (the loop's
//   counter and branch are then paid once per four lags). Neighbouring
//   threads own neighbouring positions, so each W[p - d] is one
//   conflict-free shared-memory load per warp.
//   Granular search: one warp per granule position p = 8i, 32 lags per
//   round, a warp max-reduction of the packed candidates per round; the
//   fine result of p (kept in shared memory) is the starting value. One
//   thread per granule would read W[8i - d] with a stride of 8 words, an
//   8-way bank conflict.
// Exact early exit: lags are visited in ascending order and every coarse
// lag is larger than every fine lag, so once a position's bucket reaches
// the longest its remaining length allows (64, or less near the end of the
// block) no later lag beats it in the packed max, and the position stops.
// A position also stops at lag p: a longer lag has no source.
//
// Shared memory: round16(bs) bytes (the staged bytes, then the fine
// results of the granule positions) + 4 * bs bytes of words = 81920 bytes
// at bs 16384, two CTAs per SM; 40960 at 8192, four.
//
// What bounds it: integer compare issue and shared-memory load issue. Each
// visited (position, lag) pair costs one 4-byte shared load, a compare and
// the loop's branch; inputs and outputs are 4 bytes per position, so device
// memory is not the limit. Several positions per thread, a packed
// compare of four lags at once, or a hash of each position's word to skip
// lags that cannot match are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr int kMaxBlockSize = 16384;  // pallas_encode.py:47, MAX_SWEEP_BLOCK
constexpr int kThreads = 512;
constexpr int kMaxWords = 16;  // a 64-byte run
constexpr int kCoarseStep = 8;  // the sampled coarse sweep's lag stride
constexpr size_t kMaxSharedBytes = 232448;  // per-block limit on sm_90

size_t shared_bytes(int bs) { return 4 * static_cast<size_t>(bs) + pim::round16(bs); }

// The bucketed length of a run of k whole matching words.
__device__ __forceinline__ int bucket(int k) {
  return k >= 16 ? 64 : k >= 8 ? 32 : k >= 4 ? 16 : k >= 2 ? 8 : k >= 1 ? 4 : 0;
}

// Whole matching words from p at lag d, given that the first word matches:
// at most maxk, the words that fit before the block's length.
__device__ __forceinline__ int run_words(const uint32_t* w, int p, int d, int maxk) {
  int k = 1;
  while (k < maxk && w[p + 4 * k] == w[p - d + 4 * k]) ++k;
  return k;
}

// Whole words a run needs for a bucket longer than best_len (at least
// floor): 4 bytes -> 2 words, 8 -> 4, 16 -> 8, 32 -> 16.
__device__ __forceinline__ int words_to_beat(int best_len, int floor) {
  return max(floor, best_len >> 1);
}

__device__ __forceinline__ void put(uint8_t* mlen, uint16_t* mlag, size_t at, int best) {
  const int len = best >> 16;
  mlen[at] = static_cast<uint8_t>(len);
  mlag[at] = len ? static_cast<uint16_t>(0xFFFF - (best & 0xFFFF)) : 0;
}

__global__ void __launch_bounds__(kThreads)
    sweep_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                        uint8_t* __restrict__ mlen, uint16_t* __restrict__ mlag, int bs, int window,
                        int coarse, int granular) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_data = smem;
  uint32_t* w = reinterpret_cast<uint32_t*>(smem + pim::round16(bs));
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = min(max(lens[b], 0), bs);
  const size_t row = static_cast<size_t>(b) * bs;

  pim::stage_row(s_data, blocks + row, len, pim::round16(bs), tid, kThreads);
  __syncthreads();
  for (int p = tid; p < bs; p += kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int k = 3; k >= 0; --k) v = (v << 8) | (p + k < bs ? s_data[p + k] : 0u);
    w[p] = v;
  }
  __syncthreads();
  int32_t* gbest = reinterpret_cast<int32_t*>(s_data);  // the staged bytes are done with

  // Fine sweep, and in sampled mode the every-8th coarse lags.
  const bool sampled = !granular && coarse > window;
  for (int p = tid; p < bs; p += kThreads) {
    int best = 0;  // (length << 16) | (0xFFFF - lag), 0 = no match
    if (p + 4 <= len) {
      const uint32_t w0 = w[p];
      const int maxk = min(kMaxWords, (len - p) >> 2);
      const int top = bucket(maxk);
      int best_len = 0, best_d = 0;
      // A lag whose first word matches: measure its run, keep it if its
      // bucket is longer; true once the bucket is `top`.
      auto visit = [&](int d) {
        // A run that beats best_len matches the last word it needs: one
        // compare rejects most first-word matches before the full count.
        const int need = words_to_beat(best_len, 1) - 1;
        if (w[p - d + 4 * need] != w[p + 4 * need]) return false;
        const int l = bucket(run_words(w, p, d, maxk));
        if (l <= best_len) return false;
        best_len = l;
        best_d = d;
        return l == top;
      };
      // Lags d, d + step, ... up to last, in order, four first-word
      // compares at a time; true once a lag reached `top`.
      auto scan = [&](int d, int last, int step) {
        for (; d + 3 * step <= last; d += 4 * step) {
          const bool e0 = w[p - d] == w0, e1 = w[p - d - step] == w0;
          const bool e2 = w[p - d - 2 * step] == w0, e3 = w[p - d - 3 * step] == w0;
          if (!(e0 | e1 | e2 | e3)) continue;
          if ((e0 && visit(d)) || (e1 && visit(d + step)) || (e2 && visit(d + 2 * step)) ||
              (e3 && visit(d + 3 * step))) {
            return true;
          }
        }
        for (; d <= last; d += step) {
          if (w[p - d] == w0 && visit(d)) return true;
        }
        return false;
      };
      if (!scan(1, min(window, p), 1) && sampled) scan(window + kCoarseStep, min(coarse, p), kCoarseStep);
      if (best_len) best = (best_len << 16) | (0xFFFF - best_d);
    }
    if (granular && (p & 7) == 0) {
      gbest[p >> 3] = best;
    } else {
      put(mlen, mlag, row + p, best);
    }
  }
  if (!granular) return;
  __syncthreads();

  // Granular search: one warp per granule position, 32 lags a round. Every
  // value in the loop's condition is the same on all lanes of the warp.
  const int lane = tid & 31;
  for (int i = tid >> 5; i < bs / 8; i += kThreads / 32) {
    const int p = 8 * i;
    int best = gbest[i];
    if (p + 8 <= len) {
      const uint32_t w0 = w[p];
      const int maxk = min(kMaxWords, (len - p) >> 2);
      const int top = bucket(maxk);
      const int dhi = min(coarse, p);
      for (int d0 = window + 1; d0 <= dhi && (best >> 16) < top; d0 += 32) {
        const int d = d0 + lane;
        const int need = words_to_beat(best >> 16, 2) - 1;  // the same on every lane
        int cand = 0;
        if (d <= dhi && w[p - d] == w0 && w[p - d + 4 * need] == w[p + 4 * need]) {
          const int k = run_words(w, p, d, maxk);
          if (k >= 2) cand = (bucket(k) << 16) | (0xFFFF - d);
        }
        best = max(best, __reduce_max_sync(0xffffffffu, cand));
      }
    }
    if (lane == 0) put(mlen, mlag, row + p, best);
  }
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
  const size_t smem = shared_bytes(block_size);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  st = cudaFuncSetAttribute(sweep_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem));
  if (st != cudaSuccess) return st;
  sweep_blocks_kernel<<<num_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(mlen), static_cast<uint16_t*>(mlag), block_size, window, coarse,
      granular && coarse > window ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
