// Match finding for the block-parallel modified-Snappy encoder, for Hopper (sm_90a).
//
// Replaces four TPU kernels of the JAX package and the XLA glue between them:
//   pim_compression_tpu/ops/pallas_match.py::_sort_rung_kernel      one per rung: hash
//       ladder, folded key, bitonic sort of (key << pos_bits) | pos, nearest
//       previous equal key as a lag, then a second sort to unsort
//   pim_compression_tpu/ops/pallas_match.py::_extend_fold_kernel    exact extension
//   pim_compression_tpu/ops/pallas_match.py::_prev_step_kernel      (j+1)-th previous
//       occurrence by lag composition
//   pim_compression_tpu/ops/pallas_match.py::_select_extend_kernel  sel_all capped
//       select of every candidate array, then the winner's full extension
//   the glue in sorted_match_groups: cap_lag, the rung pick, _neighbor_fold
// Its output equals lane_model_encode.match_search_sorted (stride 1, no sort
// window) with rung_pick=True, or with sel_all=True and sel_cap, on every
// position, and the plain PyTorch transcription hopper_match.match_blocks_torch.
//
// Design: one CTA per block, block sizes up to 65536. The block's bytes are
// staged once in shared memory (zero at and past lens[b], plus 64 zero bytes
// past the block, which is what the spec's zero-filled shifts read).
//
// Candidates. Per rung each thread hashes its positions straight from the
// bytes (no hash plane is kept between rungs), and the CTA bitonic-sorts the
// words (key << pos_bits) | pos in shared memory: 17 + 15 bits up to 32768
// positions, 16 + 16 above (lane_model_encode.fold_key), padded with
// 0xFFFFFFFF sentinels to a power of two (above every real word, since a
// sentinel is only needed where position 0xFFFF or 0x7FFF does not exist).
// A sorted predecessor with an equal key gives the lag of the position in the
// word's low bits, written straight to that position of a uint16 lag plane in
// device memory (Hopper threads address memory freely, so the TPU's unsort,
// its chunk-transposed word build and its span sweeps have no counterpart).
//
// 64 KB blocks. 65536 sort words are 256 KB, past the 232448 bytes a CTA may
// use. The CTA sorts each 32 KB half of the positions in turn in one 128 KB
// buffer, and copies the sorted first half to a device-memory scratch. A
// position's nearest previous equal key is its predecessor in its own half's
// sorted run; a second-half position that is first of its key in its half
// takes the last first-half position with that key, found by binary search
// of the scratch. (key, pos) words are unique, so this is exactly the spec's
// nearest previous position with an equal folded key. Chosen over a sort in
// device memory (every one of the 136 stages would go through L2) and over a
// two-CTA cluster (the sort's barriers would span SMs).
//
// Selection, per position after the last rung: the rung pick (the longest
// rung with a candidate, capped at max_lag, wins) or the select ladder: each
// candidate array in order (each rung; after the 4-byte rung its 2nd..k-th
// previous occurrences, lag_{j+1}(p) = lag_j(p) + near(p - lag_j(p)) read
// from the uncapped lag plane) gets an extension capped at sel_cap bytes, and
// a strictly longer one wins. One exact extension of the winner, capped at
// ext_cap, follows; it starts over rather than resuming from the capped
// state, which gives the same length. The neighbor fold reads the pre-fold
// lengths and lags from shared memory after a barrier.
//
// Shared memory: bytes round16(bs + 64) + sort words 4 * min(n, 32768), n
// the power of two >= bs: 163904 bytes at bs = 32768 and 196672 at 65536,
// one CTA of 1024 threads per SM.
//
// What bounds it: the sort. Each rung runs log2(n)(log2(n)+1)/2 = 120
// compare-exchange stages per 32 KB half, each a pass over 128 KB of shared
// memory and a barrier; hashing, the lag planes (2 bytes per position and
// rung, L2-resident) and the extensions are a few passes. Register-level
// sorting of the first stages, a radix sort on the key bits, or several small
// blocks per CTA are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr uint32_t kM1 = 0x9E3779B1u;  // lane_model_encode.py:183-184
constexpr uint32_t kM2 = 0x85EBCA77u;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kHalf = 32768;  // positions sorted at once in shared memory
constexpr int kMaxBlockSize = 2 * kHalf;
constexpr int kPad = 64;  // the longest rung's window
constexpr int kMaxThreads = 1024;
constexpr int kMaxPrevK = 8;
constexpr size_t kMaxSharedBytes = 232448;  // per-block limit on sm_90

__host__ __device__ inline int sort_size(int n) {
  int m = 2;
  while (m < n) m <<= 1;
  return m;
}

__host__ __device__ inline int sort_rows(int bs) {
  const int n = sort_size(bs);
  return n < kHalf ? n : kHalf;
}

__host__ __device__ inline size_t shared_bytes(int bs) {
  return static_cast<size_t>(pim::round16(bs + kPad)) + 4u * sort_rows(bs);
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

// The position of the last word with key `key` in the sorted words w[0, n),
// or -1: an upper bound on the key field.
__device__ int last_with_key(const uint32_t* w, int n, uint32_t key, int pos_bits) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((w[mid] >> pos_bits) <= key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo == 0 || (w[lo - 1] >> pos_bits) != key) return -1;
  return static_cast<int>(w[lo - 1] & ((1u << pos_bits) - 1));
}

// Leading equal bytes of p and p - lag, at most cap; kept only from 4 up.
__device__ __forceinline__ int extend(const uint8_t* s, int p, int lag, int cap) {
  if (lag <= 0) return 0;
  const uint8_t* a = s + p;
  const uint8_t* c = a - lag;
  int n = 0;
  while (n < cap && a[n] == c[n]) ++n;
  return n < 4 ? 0 : n;
}

__global__ void __launch_bounds__(kMaxThreads)
match_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                    uint8_t* __restrict__ mlen, uint16_t* __restrict__ mlag,
                    uint16_t* __restrict__ near, uint32_t* __restrict__ first_half, int bs,
                    int rung_mask, int ext_cap, int neighbor, int max_lag, int prev_k,
                    int sel_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_bytes = smem;  // round16(bs + 64)
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + pim::round16(bs + kPad));  // sort_rows(bs)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = min(max(lens[b], 0), bs);
  const size_t row = static_cast<size_t>(b) * bs;
  const int pos_bits = bs > kHalf ? 16 : 15;
  const uint32_t pos_mask = (1u << pos_bits) - 1;
  const uint32_t key_mask = (1u << (32 - pos_bits)) - 1;
  const int n_rungs = __popc(rung_mask);
  uint16_t* planes = near + static_cast<size_t>(b) * n_rungs * bs;  // [n_rungs][bs]
  uint32_t* fh = first_half + static_cast<size_t>(b) * kHalf;        // used when bs > kHalf

  pim::stage_row(s_bytes, blocks + row, len, pim::round16(bs + kPad), tid, nt);
  __syncthreads();

  // Nearest previous equal key per rung, uncapped, into the lag planes.
  for (int bit = 0, ri = 0; bit < 5; ++bit) {
    if (!(rung_mask & (1 << bit))) continue;
    const int rung = 4 << bit;
    uint16_t* plane = planes + static_cast<size_t>(ri++) * bs;
    for (int base = 0; base < bs; base += kHalf) {
      const int cnt = min(kHalf, bs - base);  // real positions in this half
      const int m = sort_size(cnt);
      for (int i = tid; i < m; i += nt) {
        uint32_t w = kSentinel;
        if (i < cnt) {
          const uint32_t h = hash_at(s_bytes, base + i, rung);
          w = (((h ^ (h >> pos_bits)) & key_mask) << pos_bits) | static_cast<uint32_t>(base + i);
        }
        s_words[i] = w;
      }
      __syncthreads();
      bitonic_sort(s_words, m, tid, nt);
      // Sorted rows [0, cnt) are the real words; equal keys sit in position order.
      for (int i = tid; i < cnt; i += nt) {
        const uint32_t w = s_words[i];
        const int pos = static_cast<int>(w & pos_mask);
        int prev = -1;
        if (i > 0 && (s_words[i - 1] >> pos_bits) == (w >> pos_bits)) {
          prev = static_cast<int>(s_words[i - 1] & pos_mask);
        } else if (base > 0) {
          prev = last_with_key(fh, kHalf, w >> pos_bits, pos_bits);
        }
        plane[pos] = static_cast<uint16_t>(prev >= 0 ? pos - prev : 0);
        if (base == 0 && bs > kHalf) fh[i] = w;
      }
      __syncthreads();
    }
  }

  // Selection and the winner's extension, per position; the pre-fold lag
  // goes to shared memory (the sort buffer is free) and the length out.
  uint16_t* s_lag = reinterpret_cast<uint16_t*>(s_words);
  for (int p = tid; p < bs; p += nt) {
    const int room = len - p;
    int sel = 0, sel_len = 0;
    for (int bit = 0, ri = 0; bit < 5; ++bit) {
      if (!(rung_mask & (1 << bit))) continue;
      const uint16_t* plane = planes + static_cast<size_t>(ri++) * bs;
      int lag = plane[p];
      const int steps = (sel_cap > 0 && bit == 0) ? prev_k : 1;
      for (int j = 1; j <= steps; ++j) {
        if (j > 1 && lag > 0) {  // lag composition on the uncapped chain
          const int more = plane[p - lag];
          lag = more > 0 ? lag + more : 0;
        }
        const int cand = (max_lag > 0 && lag > max_lag) ? 0 : lag;
        if (sel_cap == 0) {  // rung pick: a later, longer rung overrides
          if (cand > 0) sel = cand;
        } else {
          const int n = extend(s_bytes, p, cand, min(sel_cap, room));
          if (n > sel_len) {
            sel_len = n;
            sel = cand;
          }
        }
      }
    }
    const int n = extend(s_bytes, p, sel, min(ext_cap, room));
    s_lag[p] = static_cast<uint16_t>(n > 0 ? sel : 0);
    mlen[row + p] = static_cast<uint8_t>(n);
  }
  __syncthreads();
  uint8_t* s_len = s_bytes;  // the bytes are no longer read
  for (int p = tid; p < bs; p += nt) s_len[p] = mlen[row + p];
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
    mlen[row + p] = static_cast<uint8_t>(n);
    mlag[row + p] = static_cast<uint16_t>(lag);
  }
}

}  // namespace

// Match num_blocks blocks on `stream`. blocks is uint8[num_blocks, block_size],
// lens int32[num_blocks]; mlen uint8 and mlag uint16 (an int16 tensor's bits)
// are [num_blocks, block_size]. near is uint16[num_blocks, n_rungs, block_size]
// scratch; first_half is uint32[num_blocks, 32768] scratch when block_size >
// 32768 (else unused, may be null). rung_mask bit i selects rung 4 << i;
// max_lag 0 means no cap; sel_cap 0 runs the rung pick, sel_cap > 0 the
// select ladder with prev_k candidates on the 4-byte rung. Returns
// cudaGetLastError() after the launch (0 on success). Does not synchronise.
extern "C" int pim_match_blocks(const void* blocks, const void* lens, void* mlen, void* mlag,
                                void* near, void* first_half, int num_blocks, int block_size,
                                int rung_mask, int ext_cap, int neighbor, int max_lag,
                                int prev_k, int sel_cap, int device, void* stream) {
  if (num_blocks <= 0) return 0;
  if (block_size <= 0 || block_size > kMaxBlockSize || rung_mask <= 0 || rung_mask >= 32 ||
      ext_cap < 4 || ext_cap > 64 || (ext_cap & 3) || max_lag < 0 || prev_k < 1 ||
      prev_k > kMaxPrevK || sel_cap < 0 || sel_cap > ext_cap || (sel_cap & 3) ||
      (sel_cap == 0 && prev_k != 1) || near == nullptr ||
      (block_size > kHalf && first_half == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(block_size);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const int half = sort_rows(block_size) / 2;  // compare-exchange pairs per stage
  const int threads = half < kMaxThreads ? half : kMaxThreads;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  st = cudaFuncSetAttribute(match_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem));
  if (st != cudaSuccess) return st;
  match_blocks_kernel<<<num_blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens),
      static_cast<uint8_t*>(mlen), static_cast<uint16_t*>(mlag), static_cast<uint16_t*>(near),
      static_cast<uint32_t*>(first_half), block_size, rung_mask, ext_cap, neighbor, max_lag,
      prev_k, sel_cap);
  return static_cast<int>(cudaGetLastError());
}
