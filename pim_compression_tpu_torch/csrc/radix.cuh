// The pieces of the LSD radix sorts in sweep.cu (the table of word
// occurrences: multisplit, scan_counts, digits of 5-6 bits with lane-owned
// counts) and match.cu (the rung sort: peers_of, scan_wide_counts, digits of
// 8-9 bits with per-warp counts in shared memory).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pim {

// One warp-step of a radix pass over the digit (w >> shift) & (2^bits - 1),
// bits 5 or 6: the lanes with this lane's digit (peers), and those whose digit
// is this lane's own bin, lane (own_lo) or lane + 32 (own_hi).
struct Split {
  uint32_t digit, peers, own_lo, own_hi;
};

__device__ __forceinline__ Split multisplit(uint32_t w, int shift, int bits, int lane) {
  const uint32_t d = (w >> shift) & ((1u << bits) - 1);
  uint32_t peers = ~0u, own = ~0u;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const uint32_t m = __ballot_sync(~0u, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? m : ~m;
    own &= ((lane >> b) & 1) ? m : ~m;
  }
  const uint32_t m5 = bits > 5 ? __ballot_sync(~0u, (d >> 5) & 1) : 0u;  // uniform branch
  peers &= ((d >> 5) & 1) ? m5 : ~m5;
  return {d, peers, own & ~m5, own & m5};
}

// Exclusive scan, in place, of the 2 * nt uint16 digit counts (digit-major,
// warp-minor), each thread taking one adjacent pair; tot holds 32 warp totals.
// Starts and ends with the counts' writers and readers separated by barriers
// of the caller.
__device__ inline void scan_counts(uint16_t* hist, uint32_t* tot, int tid, int nt) {
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  uint32_t* pair = reinterpret_cast<uint32_t*>(hist);
  const uint32_t two = pair[tid];
  const uint32_t a = two & 0xFFFFu, s = a + (two >> 16);
  uint32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = lane < nw ? tot[lane] : 0u;
    uint32_t inc = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < nw) tot[lane] = inc - t;
  }
  __syncthreads();
  const uint32_t base = tot[warp] + incl - s;  // at most 32768: fits a uint16
  pair[tid] = base | ((base + a) << 16);
}

// The lanes whose digit d equals this lane's, d < 2^bits and bits <= 9: from
// __match_any_sync, or as the AND of the digit's ballots or their complements.
// A bit's ballot is taken on s, the bit spread over the word by an arithmetic
// shift, so that one LOP3 keeps the ballot (s all ones) or its complement.
template <bool kMatchAny>
__device__ __forceinline__ uint32_t peers_of(uint32_t d, int bits) {
  if constexpr (kMatchAny) {
    return __match_any_sync(~0u, d);
  } else {
    uint32_t peers = ~0u;
#pragma unroll
    for (int b = 0; b < 9; ++b) {
      if (b < bits) {  // uniform branch
        const uint32_t s = static_cast<uint32_t>(static_cast<int32_t>(d << (31 - b)) >> 31);
        peers &= ~(__ballot_sync(~0u, s) ^ s);
      }
    }
    return peers;
  }
}

// The uint16 slot of digit d's count for one warp, in a warp's column of
// uint32 words: word (d >> 1) * (nw + 1), the low half for even d. A word is
// touched by its own warp alone; the odd row length spreads a warp's digits
// over the banks.
__device__ __forceinline__ int wide_slot(int d, int nw) { return 2 * (d >> 1) * (nw + 1) + (d & 1); }

// Exclusive scan, in place, of the 2^bits x nw uint16 digit counts (bits 8 or
// 9) of hist, whose warp w's column starts at word w, in digit-major,
// warp-minor order: each thread takes 2^bits / 32 adjacent counts. tot holds
// 32 warp totals. Starts and ends with the counts' writers and readers
// separated by barriers of the caller.
__device__ inline void scan_wide_counts(uint32_t* hist, uint32_t* tot, int bits, int tid, int nt) {
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5, lg = __ffs(nw) - 1;
  const int per = 1 << (bits - 5), k0 = tid * per;
  uint16_t* h16 = reinterpret_cast<uint16_t*>(hist);
  uint32_t s = 0;
#pragma unroll 1  // unrolled, these loops left the traced match kernel 4 bytes of spills
  for (int k = k0; k < k0 + per; ++k) s += h16[2 * (k & (nw - 1)) + wide_slot(k >> lg, nw)];
  uint32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = lane < nw ? tot[lane] : 0u;
    uint32_t inc = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane < nw) tot[lane] = inc - t;
  }
  __syncthreads();
  uint32_t run = tot[warp] + incl - s;  // at most 32768: fits a uint16
#pragma unroll 1
  for (int k = k0; k < k0 + per; ++k) {
    const int i = 2 * (k & (nw - 1)) + wide_slot(k >> lg, nw);
    const uint32_t c = h16[i];
    h16[i] = static_cast<uint16_t>(run);
    run += c;
  }
}

}  // namespace pim
