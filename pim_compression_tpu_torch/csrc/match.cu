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
// staged once in shared memory (zero at and past lens[b], plus 64 zero bytes
// past the block, which is what the spec's zero-filled shifts read).
//
// Candidates. Per rung each thread hashes its rows straight from the bytes (no
// hash plane is kept between rungs), and the CTA bitonic-sorts the words
// (key << pos_bits) | row in shared memory. A rung of stride s sorts the rows
// p / s of the positions p = 0, s, 2s, ...; pos_bits is 15 unless the rung's
// padded row count (the block's power-of-two sort size over s) exceeds 32768,
// then 16 (lane_model_encode.fold_key). Words are padded with 0xFFFFFFFF
// sentinels to a power of two; a real word can equal a sentinel only in a full
// sort, which has none, so the real words are the first ones sorted. A sorted
// predecessor with an equal key gives the row's lag, times s, written straight
// to that position of a uint16 lag plane in device memory; positions off the
// stride get 0 (Hopper threads address memory freely, so the TPU's unsort, its
// chunk-transposed word build, its compaction and its span sweeps have no
// counterpart).
//
// Sort windows. A window of W bytes sorts each aligned group of W / s rows on
// its own, and a row takes a predecessor only from its group. The bitonic
// network stops at merge size W / s and runs that last merge ascending in every
// group (the standard network would leave every other group descending). The
// sentinels of a partial last group sort to its end, past the real words.
//
// 64 KB blocks. 65536 sort words are 256 KB, past the 232448 bytes a CTA may
// use. A stride-1 rung with no window sorts each 32 KB half of the positions in
// turn in one 128 KB buffer, and copies the sorted first half to a device-memory
// scratch. A position's nearest previous equal key is its predecessor in its own
// half's sorted run; a second-half position that is first of its key in its half
// takes the last first-half position with that key, found by binary search of
// the scratch. (key, pos) words are unique, so this is exactly the spec's
// nearest previous position with an equal folded key. A strided rung has at most
// 32768 rows, and a windowed one sorts groups of at most 32768 rows in turn, so
// neither needs the search. Chosen over a sort in device memory (every one of
// the 136 stages would go through L2) and over a two-CTA cluster (the sort's
// barriers would span SMs).
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
// the same length. The neighbor fold reads the pre-fold lengths and lags from
// shared memory after a barrier.
//
// Shared memory: bytes round16(bs + 64) + sort words 4 * min(n, 32768), n the
// power of two >= bs: 163904 bytes at bs = 32768 and 196672 at 65536, one CTA
// of 1024 threads per SM.
//
// What bounds it: the sort. A rung of R sorted rows in groups of G runs
// log2(G)(log2(G)+1)/2 compare-exchange stages per sort of up to 32768 rows,
// each a pass over the buffer and a barrier: 120 for a full 32 KB sort, 105 at
// stride 2, 91 for a 8192-row window. Hashing, the lag planes (2 bytes per
// position and rung, L2-resident) and the extensions are a few passes.
// Register-level sorting of the first stages, a radix sort on the key bits, or
// several small blocks per CTA are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr uint32_t kM1 = 0x9E3779B1u;  // lane_model_encode.py:183-184
constexpr uint32_t kM2 = 0x85EBCA77u;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kHalf = 32768;  // rows sorted at once in shared memory
constexpr int kMaxBlockSize = 2 * kHalf;
constexpr int kPad = 64;  // the longest rung's window
constexpr int kMaxThreads = 1024;
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

__host__ __device__ inline size_t shared_bytes(int bs) {
  return static_cast<size_t>(pim::round16(bs + kPad)) + 4u * sort_rows(bs);
}

// The stride of the rung 4 << bit: 2 bits of log2(stride) per rung.
__host__ __device__ inline int rung_stride(int stride_code, int bit) {
  return 1 << ((stride_code >> (2 * bit)) & 3);
}

// A rung's rows in the block padded to its power-of-two sort size.
__host__ __device__ inline int padded_rows(int bs, int stride) {
  const int rows = sort_size(bs) / stride;
  return rows > 1 ? rows : 1;
}

// Rows a rung sorts as one group: window / stride, or all its padded rows.
__host__ __device__ inline int group_rows(int bs, int stride, int window) {
  const int rows = padded_rows(bs, stride);
  return (window > 0 && window / stride < rows) ? window / stride : rows;
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

// Ascending bitonic sort of each aligned run of `group` words in w[0, n), by
// the whole CTA; n and group are powers of two and group divides n. The last
// merge (k == group) runs ascending in every group.
__device__ void bitonic_sort(uint32_t* w, int n, int group, int tid, int nthreads) {
  for (int k = 2; k <= group; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n / 2; i += nthreads) {
        const int a = 2 * i - (i & (j - 1));  // i with a zero bit inserted at j
        const int b = a + j;
        const uint32_t x = w[a], y = w[b];
        const bool up = k == group || (a & k) == 0;
        if ((x > y) == up) {
          w[a] = y;
          w[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The row of the last word with key `key` in the sorted words w[0, n), or -1:
// an upper bound on the key field.
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
                    int sel_cap, int mode, int stride_code, int window) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_bytes = smem;  // round16(bs + 64)
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + pim::round16(bs + kPad));  // sort_rows(bs)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int len = min(max(lens[b], 0), bs);
  const size_t row_base = static_cast<size_t>(b) * bs;
  const int n_rungs = __popc(rung_mask);
  uint16_t* planes = near + static_cast<size_t>(b) * n_rungs * bs;  // [n_rungs][bs]
  uint32_t* fh = first_half + static_cast<size_t>(b) * kHalf;        // used by a split sort

  pim::stage_row(s_bytes, blocks + row_base, len, pim::round16(bs + kPad), tid, nt);
  __syncthreads();

  // Nearest previous equal key per rung, uncapped, into the lag planes.
  for (int bit = 0, ri = 0; bit < 5; ++bit) {
    if (!(rung_mask & (1 << bit))) continue;
    const int rung = 4 << bit;
    const int stride = rung_stride(stride_code, bit);
    const int rows_pad = padded_rows(bs, stride);
    const int pos_bits = rows_pad > kHalf ? 16 : 15;
    const uint32_t pos_mask = (1u << pos_bits) - 1;
    const uint32_t key_mask = (1u << (32 - pos_bits)) - 1;
    const int cnt = (bs + stride - 1) / stride;  // real rows
    const int group = group_rows(bs, stride, window);
    const int chunk = min(kHalf, rows_pad);  // rows sorted at once
    const bool split = group > chunk;        // stride 1, no window, above 32768 rows
    uint16_t* plane = planes + static_cast<size_t>(ri++) * bs;
    if (stride > 1) {
      for (int p = tid; p < bs; p += nt) {
        if (p % stride) plane[p] = 0;
      }
    }
    for (int r0 = 0; r0 < cnt; r0 += chunk) {
      const int real = min(chunk, cnt - r0);
      const int n = split ? sort_size(real) : max(group, sort_size(real));
      const int g = split ? n : group;
      for (int i = tid; i < n; i += nt) {
        uint32_t w = kSentinel;
        if (i < real) {
          const int row = r0 + i;
          const uint32_t h = hash_at(s_bytes, row * stride, rung);
          w = (((h ^ (h >> pos_bits)) & key_mask) << pos_bits) | static_cast<uint32_t>(row);
        }
        s_words[i] = w;
      }
      __syncthreads();
      bitonic_sort(s_words, n, g, tid, nt);
      // Sorted slots [0, real) hold the real words; equal keys sit in row order.
      for (int i = tid; i < real; i += nt) {
        const uint32_t w = s_words[i];
        const int row = static_cast<int>(w & pos_mask);
        int prev = -1;
        if ((i & (g - 1)) > 0 && (s_words[i - 1] >> pos_bits) == (w >> pos_bits)) {
          prev = static_cast<int>(s_words[i - 1] & pos_mask);
        } else if (split && r0 > 0) {
          prev = last_with_key(fh, kHalf, w >> pos_bits, pos_bits);
        }
        plane[row * stride] = static_cast<uint16_t>(prev >= 0 ? (row - prev) * stride : 0);
        if (split && r0 == 0) fh[i] = w;
      }
      __syncthreads();
    }
  }

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
}

}  // namespace

// Match num_blocks blocks on `stream`. blocks is uint8[num_blocks, block_size],
// lens int32[num_blocks]; mlen uint8 and mlag uint16 (an int16 tensor's bits)
// are [num_blocks, block_size]. near is uint16[num_blocks, n_rungs, block_size]
// scratch; first_half is uint32[num_blocks, 32768] scratch when some rung sorts
// more than 32768 rows in one group (stride 1, no window, block_size > 32768;
// else unused, may be null). rung_mask bit i selects rung 4 << i; stride_code
// bits 2i..2i+1 hold log2 of its stride (the 4-byte rung's must be 0); window
// is the sort window in bytes (0 = none; else a power of two >= 512 that
// divides the block's power-of-two sort size). max_lag 0 means no cap. mode 0
// is the rung pick (prev_k 1, sel_cap 0), 1 the select ladder (sel_cap > 0),
// 2 the per-rung ladder; modes 1 and 2 take prev_k candidates on the 4-byte
// rung. Returns cudaGetLastError() after the launch (0 on success). Does not
// synchronise.
extern "C" int pim_match_blocks(const void* blocks, const void* lens, void* mlen, void* mlag,
                                void* near, void* first_half, int num_blocks, int block_size,
                                int rung_mask, int ext_cap, int neighbor, int max_lag,
                                int prev_k, int sel_cap, int mode, int stride_code, int window,
                                int device, void* stream) {
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
      const int stride = rung_stride(stride_code, bit);
      split = split || group_rows(block_size, stride, window) > kHalf;
    }
  }
  if (split && first_half == nullptr) return cudaErrorInvalidValue;
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
      prev_k, sel_cap, mode, stride_code, window);
  return static_cast<int>(cudaGetLastError());
}
