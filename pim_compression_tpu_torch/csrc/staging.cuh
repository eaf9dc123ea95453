// Shared-memory staging used by the encode kernels (match.cu, emit.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pim {

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Copy src[0, n) into dst[0, total) and zero dst[n, total), with every
// thread of the block taking 16-byte pieces. total is a multiple of 16 and
// dst is 16-byte aligned; src is read in 16-byte words when it is aligned.
// Nothing at or past src[n] is read.
__device__ inline void stage_row(uint8_t* dst, const uint8_t* src, int n, int total,
                                 int tid, int nthreads) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = tid; i < total / 16; i += nthreads) {
    const int base = i * 16;
    union {
      uint4 v;
      uint8_t c[16];
    } u;
    if (aligned && base + 16 <= n) {
      u.v = reinterpret_cast<const uint4*>(src)[i];
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) u.c[k] = base + k < n ? src[base + k] : 0;
    }
    reinterpret_cast<uint4*>(dst)[i] = u.v;
  }
}

}  // namespace pim
