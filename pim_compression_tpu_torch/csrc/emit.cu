// Block emit for the block-parallel modified-Snappy encoder, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package that turn a block's matches
// into its compressed bytes, and the XLA glue before them:
//   pim_compression_tpu/ops/pallas_encode.py::_emit_kernel  greedy accept scan
//       (_greedy_chunk128), literal runs, header sizes, prefix sum, and the
//       routed 1-4-byte token payloads (_route_tokens)
//   pim_compression_tpu/ops/pallas_encode.py::_emit_kernel_wide  the same for
//       32 KB < bs <= 64 KB, its layout planes streamed through HBM
//   the lazy-1 glue in encode_blocks_pallas (a position's length is dropped
//   when the next position's is longer)
// Its output equals lane_model_encode.lazy_defer + greedy_parse +
// layout_and_emit, and the plain PyTorch version hopper_encode.emit_blocks_torch,
// byte for byte (bytes past each block's size are 0).
//
// Design: one CTA per block, block sizes up to 65536. All 256 threads stage
// the block's bytes and match lengths in shared memory and zero the output
// staging; the lags stay in device memory, read once per copy (their int16
// bits read unsigned: a 64 KB block's lags reach 65535, and a COPY_2 carries
// 16 offset bits, so the stream equals the narrow path's, as the TPU pair's
// test_pallas_encode_wide_emit_parity asserts). Then one warp walks the
// greedy parse the way a serial compressor does. At an accepted position
// whose deferred length is 4 or more, lane 0 writes the 2- or 3-byte copy
// tag. Otherwise a literal run starts there; the warp finds its
// end (the next position with a deferred length of 4 or more, or the block's
// length) 32 positions at a time with a ballot, lane 0 writes the 1-3 header
// bytes and the 32 lanes copy the run. The TPU's accept scan, prefix sum and
// token routing exist because a TPU lane cannot address memory at will; a
// serial walk gives every element its output offset directly. Last, all
// threads write the staged row out in 16-byte words.
//
// Shared memory, bytes + lengths + output: at bs = 32768, cap = 38272,
// 32768 + 32800 + 38272 = 103840 (two CTAs per SM); at bs = 65536, cap =
// 76544, 65536 + 65568 + 76544 = 207648 (one CTA per SM).
//
// What bounds it: the serial walk, a chain of dependent shared-memory reads
// per element (about one element per 5-10 input bytes on text). A parallel
// parse (speculative segments that resynchronise) or several blocks per CTA
// are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlockSize = 65536;
constexpr int kLenPad = 32;  // zero lengths past the block: the lookahead reads them
constexpr size_t kMaxSharedBytes = 232448;  // per-block limit on sm_90

__host__ __device__ inline size_t shared_bytes(int bs, int cap) {
  return 2u * pim::round16(bs) + kLenPad + pim::round16(cap);
}

// lazy_defer: a position's length, or 0 when the next one is longer.
__device__ __forceinline__ int deferred(const uint8_t* s_len, int p) {
  const int n = s_len[p];
  return s_len[p + 1] > n ? 0 : n;
}

__global__ void __launch_bounds__(kThreads)
emit_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                   const uint8_t* __restrict__ mlen, const uint16_t* __restrict__ mlag,
                   uint8_t* __restrict__ comp, int32_t* __restrict__ sizes, int bs, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bs16 = pim::round16(bs);
  uint8_t* s_data = smem;                                              // bs16
  uint8_t* s_len = s_data + bs16;                                      // bs16 + 32
  uint8_t* s_out = s_len + bs16 + kLenPad;                             // round16(cap)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = min(max(lens[b], 0), bs);
  const size_t row = static_cast<size_t>(b) * bs;

  pim::stage_row(s_data, blocks + row, n, bs16, tid, kThreads);
  pim::stage_row(s_len, mlen + row, bs, bs16 + kLenPad, tid, kThreads);
  uint4* s_out16 = reinterpret_cast<uint4*>(s_out);
  for (int i = tid; i < pim::round16(cap) / 16; i += kThreads) s_out16[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (tid < 32) {
    const int lane = tid;
    // Every lane runs the same control flow; lane 0 writes the headers.
    auto put = [&](int i, uint32_t v) {
      if (i < cap) s_out[i] = static_cast<uint8_t>(v);
    };
    int p = 0;  // next accepted position
    int o = 0;  // output size so far
    while (p < n) {
      const int d = deferred(s_len, p);
      if (d >= 4) {  // copy: copy1 iff len < 12 and offset < 2048
        const uint32_t off = mlag[row + p];
        const bool one = d < 12 && off < 2048;
        if (lane == 0) {
          if (one) {
            put(o, 1u | (static_cast<uint32_t>(d - 4) << 2) | ((off >> 8) << 5));
            put(o + 1, off & 0xFF);
          } else {
            put(o, 2u | (static_cast<uint32_t>(d - 1) << 2));
            put(o + 1, off & 0xFF);
            put(o + 2, (off >> 8) & 0xFF);
          }
        }
        o += one ? 2 : 3;
        p += d;
      } else {  // literal run [p, end)
        int end = n;
        for (int q = p + 1; q < n; q += 32) {
          const int pos = q + lane;
          const bool stop = pos >= n || deferred(s_len, pos) >= 4;
          const unsigned m = __ballot_sync(0xffffffffu, stop);
          if (m) {
            end = min(q + __ffs(m) - 1, n);
            break;
          }
        }
        const int run = end - p;
        const uint32_t l1 = static_cast<uint32_t>(run - 1);
        const int h = l1 < 60 ? 1 : (l1 < 256 ? 2 : 3);
        if (lane == 0) {
          if (h == 1) {
            put(o, l1 << 2);
          } else {
            put(o, (h == 2 ? 60u : 61u) << 2);
            put(o + 1, l1 & 0xFF);
            if (h == 3) put(o + 2, (l1 >> 8) & 0xFF);
          }
        }
        for (int i = lane; i < run; i += 32) put(o + h + i, s_data[p + i]);
        o += h + run;
        p = end;
      }
    }
    if (lane == 0) sizes[b] = o;
  }
  __syncthreads();

  // Write the whole row back (bytes past the size are 0), coalesced.
  uint8_t* dst = comp + static_cast<size_t>(b) * cap;
  if ((cap & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4* dst16 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < cap / 16; i += kThreads) dst16[i] = s_out16[i];
  } else {
    for (int i = tid; i < cap; i += kThreads) dst[i] = s_out[i];
  }
}

}  // namespace

// Emit num_blocks blocks on `stream`. blocks and mlen are uint8 and mlag uint16
// (an int16 tensor's bits) [num_blocks, block_size]; lens and sizes
// int32[num_blocks]; comp is
// uint8[num_blocks, cap]. Returns cudaGetLastError() after the launch (0 on
// success). Does not synchronise.
extern "C" int pim_emit_blocks(const void* blocks, const void* lens, const void* mlen,
                               const void* mlag, void* comp, void* sizes, int num_blocks,
                               int block_size, int cap, int device, void* stream) {
  if (num_blocks <= 0) return 0;
  if (block_size <= 0 || block_size > kMaxBlockSize || cap <= 0) return cudaErrorInvalidValue;
  const size_t smem = shared_bytes(block_size, cap);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  st = cudaFuncSetAttribute(emit_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem));
  if (st != cudaSuccess) return st;
  emit_blocks_kernel<<<num_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(mlen), static_cast<const uint16_t*>(mlag),
      static_cast<uint8_t*>(comp), static_cast<int32_t*>(sizes), block_size, cap);
  return static_cast<int>(cudaGetLastError());
}
