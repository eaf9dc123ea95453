// Match finding for the block-parallel modified-Snappy encoder, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package and the XLA glue between them:
//   pim_compression_tpu/ops/pallas_match.py::_sort_rung_kernel    one per rung: hash
//       ladder, 17-bit folded key, bitonic sort of (key << 15) | pos, nearest
//       previous equal key as a lag, then a second sort to unsort
//   pim_compression_tpu/ops/pallas_match.py::_extend_fold_kernel  exact extension
//   the glue in sorted_match_groups: cap_lag, the rung pick, _neighbor_fold
// Its output equals lane_model_encode.match_search_sorted(rung_pick=True,
// prev_k=1, stride 1, no sort window) on every position, and the plain
// PyTorch transcription hopper_match.match_blocks_torch.
//
// Design: one CTA per block, everything in dynamic shared memory. The block's
// bytes are staged once (zero at and past lens[b], plus 64 zero bytes past
// the block, which is what the spec's zero-filled shifts read). Per rung each
// thread hashes its positions straight from the bytes, so no hash plane is
// kept between rungs; the CTA bitonic-sorts the bs words (key17 << 15) | pos,
// padded with 0xFFFFFFFF sentinels to a power of two (a real word is below
// that whenever bs < 32768, and bs = 32768 needs no padding). A sorted
// predecessor with an equal key gives the candidate of the position in the
// word's low bits; it is capped at max_lag and written straight to that
// position (the rung pick: a later, longer rung overwrites where it has a
// candidate). Hopper threads address shared memory freely, so the TPU's
// unsort, its chunk-transposed word build and its span sweeps have no
// counterpart. After the last rung the sort buffer is free and holds the
// extension lengths; the neighbor fold reads them after a barrier.
//
// Shared memory at bs = 32768: bytes 32832 + sort words 131072 + candidate
// plane (uint16) 65536 = 229440 of the 232448 a CTA may use, so one CTA runs
// per SM with 1024 threads.
//
// What bounds it: the sort. Each rung runs log2(n)(log2(n)+1)/2 = 120
// compare-exchange stages at n = 32768, each a pass over 128 KB of shared
// memory and a barrier; hashing and extension are a few passes. Register-
// level sorting of the first stages, a radix sort on the 17 key bits, or
// several small blocks per CTA are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr uint32_t kM1 = 0x9E3779B1u;  // lane_model_encode.py:183-184
constexpr uint32_t kM2 = 0x85EBCA77u;
constexpr int kPosBits = 15;
constexpr uint32_t kPosMask = (1u << kPosBits) - 1;
constexpr uint32_t kKeyMask = (1u << 17) - 1;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kMaxBlockSize = 1 << kPosBits;
constexpr int kPad = 64;  // the longest rung's window
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSharedBytes = 232448;  // per-block limit on sm_90

__host__ __device__ inline int sort_size(int bs) {
  int n = 2;
  while (n < bs) n <<= 1;
  return n;
}

__host__ __device__ inline size_t shared_bytes(int bs) {
  return static_cast<size_t>(pim::round16(bs + kPad)) + 4u * sort_size(bs) +
         2u * pim::round16(bs);
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

// Ascending bitonic sort of w[0, n), n a power of two, by the whole CTA.
__device__ void bitonic_sort(uint32_t* w, int n, int tid, int nthreads) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n / 2; i += nthreads) {
        const int a = 2 * i - (i & (j - 1));  // i with a zero bit inserted at j
        const int b = a + j;
        const uint32_t x = w[a], y = w[b];
        if ((x > y) == ((a & k) == 0)) {
          w[a] = y;
          w[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
match_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                    uint8_t* __restrict__ mlen, int16_t* __restrict__ mlag, int bs,
                    int rung_mask, int ext_cap, int neighbor, int max_lag) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_sort = sort_size(bs);
  uint8_t* s_bytes = smem;                                            // round16(bs + 64)
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + pim::round16(bs + kPad));  // n_sort
  uint16_t* s_sel = reinterpret_cast<uint16_t*>(s_words + n_sort);   // round16(bs)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = min(max(lens[b], 0), bs);
  const size_t row = static_cast<size_t>(b) * bs;

  pim::stage_row(s_bytes, blocks + row, len, pim::round16(bs + kPad), tid, nt);
  for (int p = tid; p < bs; p += nt) s_sel[p] = 0;
  __syncthreads();

  for (int bit = 0; bit < 5; ++bit) {
    if (!(rung_mask & (1 << bit))) continue;
    const int rung = 4 << bit;
    for (int p = tid; p < n_sort; p += nt) {
      uint32_t w = kSentinel;
      if (p < bs) {
        const uint32_t h = hash_at(s_bytes, p, rung);
        w = (((h ^ (h >> kPosBits)) & kKeyMask) << kPosBits) | static_cast<uint32_t>(p);
      }
      s_words[p] = w;
    }
    __syncthreads();
    bitonic_sort(s_words, n_sort, tid, nt);
    // Sorted rows [0, bs) are the real words; equal keys sit in position order.
    for (int i = tid + 1; i < bs; i += nt) {
      const uint32_t w = s_words[i], prev = s_words[i - 1];
      if ((w >> kPosBits) == (prev >> kPosBits)) {
        const int pos = static_cast<int>(w & kPosMask);
        const int lag = pos - static_cast<int>(prev & kPosMask);
        if (max_lag == 0 || lag <= max_lag) s_sel[pos] = static_cast<uint16_t>(lag);
      }
    }
    __syncthreads();
  }

  // Exact extension of the picked candidate: leading equal bytes, at most
  // min(ext_cap, len - p); kept only from 4 bytes up.
  uint8_t* s_len = reinterpret_cast<uint8_t*>(s_words);  // the sort buffer is free now
  for (int p = tid; p < bs; p += nt) {
    const int lag = s_sel[p];
    int n = 0;
    if (lag > 0) {
      const int cap = min(ext_cap, len - p);
      const uint8_t* a = s_bytes + p;
      const uint8_t* c = a - lag;
      while (n < cap && a[n] == c[n]) ++n;
      if (n < 4) n = 0;
    }
    s_len[p] = static_cast<uint8_t>(n);
  }
  __syncthreads();

  // Neighbor fold (derive_neighbor): take p-1's match one byte shorter when
  // it is at least 4 and strictly longer than p's own.
  for (int p = tid; p < bs; p += nt) {
    int n = s_len[p];
    int lag = n > 0 ? s_sel[p] : 0;
    if (neighbor && p > 0) {
      const int inherited = static_cast<int>(s_len[p - 1]) - 1;
      if (inherited >= 4 && inherited > n) {
        n = inherited;
        lag = s_sel[p - 1];
      }
    }
    mlen[row + p] = static_cast<uint8_t>(n);
    mlag[row + p] = static_cast<int16_t>(lag);
  }
}

}  // namespace

// Match num_blocks blocks on `stream`. blocks is uint8[num_blocks, block_size],
// lens int32[num_blocks]; mlen uint8 and mlag int16 are [num_blocks, block_size].
// rung_mask bit i selects rung 4 << i; max_lag 0 means no cap. Returns
// cudaGetLastError() after the launch (0 on success). Does not synchronise.
extern "C" int pim_match_blocks(const void* blocks, const void* lens, void* mlen, void* mlag,
                                int num_blocks, int block_size, int rung_mask, int ext_cap,
                                int neighbor, int max_lag, int device, void* stream) {
  if (num_blocks <= 0) return 0;
  if (block_size <= 0 || block_size > kMaxBlockSize || rung_mask <= 0 || rung_mask >= 32 ||
      ext_cap < 4 || ext_cap > 64 || (ext_cap & 3) || max_lag < 0)
    return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(block_size);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const int half = sort_size(block_size) / 2;  // compare-exchange pairs per stage
  const int threads = half < kMaxThreads ? half : kMaxThreads;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  st = cudaFuncSetAttribute(match_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem));
  if (st != cudaSuccess) return st;
  match_blocks_kernel<<<num_blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(mlen), static_cast<int16_t*>(mlag), block_size, rung_mask, ext_cap,
      neighbor, max_lag);
  return static_cast<int>(cudaGetLastError());
}
