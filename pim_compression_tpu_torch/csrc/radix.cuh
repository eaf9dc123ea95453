// The warp-ballot pieces of the LSD radix sorts in match.cu (the rung sort)
// and sweep.cu (the table of word occurrences).
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

}  // namespace pim
