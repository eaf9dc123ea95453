// Hardware probes for Hopper (sm_90a): the H100 counterparts of the JAX
// package's TPU probe kernels. They measure what the codec's kernels pay:
// a dependent gather, a dependent integer op, and copies.
//
// Replaces five TPU kernels:
//   scripts/hw_probe.py::gather_kernel        x <- take_along_axis(x, idx, axis=1) ^ 1
//       on an int32 (128, 128) plane, iters times          -> gather_chain_kernel
//   scripts/hw_probe.py::ew_kernel            x <- (x + idx) ^ 1, the same plane  -> ew_chain_kernel
//   scripts/transfer_probe.py::kern_copy      out = x[0:out_rows] + 1, or, with more output
//       rows than input rows, out = x[0] broadcast (no + 1) -> copy_rows_kernel
//   scripts/transfer_probe.py::kern_compute   v <- (v * -1640531527) ^ (v >> 3) on an
//       int32 (rows, 128) plane, then out[s, l] = sum over g of v[8g + s, l]
//   scripts/emu_calibrate.py::chain_kernel    the same recurrence and fold from
//       v0[r, l] = x[0, l] + r                               -> mix_rounds_kernel (both)
//
// Gather chain. A row only reads itself, so each row has its own CTA of
// one warp: 128 CTAs, which the scheduler puts on 128 distinct SMs, and
// nothing passes between them (no __syncthreads, nothing across CTAs). The
// TPU kernel ran on the v5e's only TensorCore, the whole chip; a single CTA
// would measure one of the H100's 132 SMs. The warp keeps its 512-byte row
// in shared memory twice (two slices): lane l owns columns l + 32 j, j < 4,
// and keeps their source columns idx & 127 in registers for the whole
// loop. A step reads one slice (4 loads a lane, at random banks inside the
// row), writes the other (4 stores xor 1, conflict-free) and ends in one
// __syncwarp; with two slices no store can overwrite a word another lane
// has still to read, so no second __syncwarp is needed. Every one of the
// iters steps runs: the map x -> x[idx] ^ 1 is never composed. What bounds
// it: one dependent step's latency, a shared-memory load behind its bank
// conflicts, the xor, the store and the warp's sync: about 32 ns (63
// cycles at 1980 MHz) a step on an H100 80GB HBM3, 700 W. One warp an SM
// has nothing to overlap it with, so the operations bound
// (work_ledger.probe_work) stays far off. Shuffles (the row in registers,
// 16 a step) and four warps a CTA were slower on the same card.
//
// Elementwise chain. One element a thread, v <- (v + idx) ^ 1 in a
// register: 128 CTAs of 128 threads, a row a CTA, one warp on each of an
// SM's four schedulers. Each element is its own chain, and the loop keeps
// both of a step's operations (the chain's per-element closed form is not
// used; the compiled loop issues an IMAD.IADD and a LOP3 a step). What
// bounds it: the latency of that dependent add and xor, about 5.5 ns (11
// cycles) a step on an H100; with one warp a scheduler nothing hides it,
// and issue (2 instructions a step) is a fraction of it.
//
// Both chains write the whole final plane, and the wrapper returns its rows
// 0:8 (the TPU kernel's output). Storing rows 0:8 alone would let the
// compiler drop the loop of the other rows' CTAs under the store's
// condition; the TPU compiler removed such work too
// (scripts/emu_calibrate.py:73-79).
//
// Copy. Grid-stride over 16-byte vectors (a row of 128 int32 is 32 of
// them), the grid sized so that each thread keeps kCopyInFlight loads in
// flight before its stores: with one load at a time it ran about 4 % behind
// PyTorch's x[:rows] + 1, timed in turns on an H100. Indices are 32-bit:
// the entry refuses a count that does not fit them. What bounds it: device
// memory, one read and one write a vector.
//
// Compute and chain (one kernel, a flag for the starting plane). One
// thread per element, the recurrence in registers, then one atomicAdd on
// unsigned per element into the zeroed (8, 128) output: addition modulo
// 2^32 is order-free, so the fold is exact and equals the TPU kernel's
// wrapping int32 sum. The multiply is done in uint32 (0x9E3779B9 is
// -1640531527), as signed overflow is undefined in C++; v >> 3 stays an
// arithmetic shift of the signed value, as jnp's >> on int32 is, and both
// operands come from the old v. What bounds it: integer issue when enough
// warps are resident: the multiply goes to the FMA pipe, the shift and the
// xor to the 64 INT32 lanes of an SM, so a round takes one SM clock a warp
// (about 24e12 int32 ops/s on an H100, above the 64 lanes' 16.7e12); the
// latency of the dependent chain when few warps are (8 rows are 1024
// threads on 4 SMs: about 11 cycles a round). The fold's atomics are one
// per element, noise beside the rounds.
//
// Every entry point returns cudaGetLastError() after its launch (0 on
// success), launches on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kPlaneRows = 128;
constexpr int kColsPerLane = kLanes / 32;  // 4: a gather lane's columns, lane + 32 j
constexpr int kEwThreads = 128;  // one element a thread: a CTA a row
constexpr int kCopyThreads = 256;
constexpr int kCopyMaxBlocks = 132 * 8;
constexpr int kCopyInFlight = 4;  // 16-byte loads a copy thread issues before its stores
constexpr int kMixThreads = 256;
constexpr uint32_t kMul = 0x9E3779B9u;  // -1640531527 as uint32

// One step of the gather chain on a warp's row: to[c] = from[src[c]] ^ 1
// for the lane's 4 columns c = lane + 32 j, then __syncwarp so the next
// step reads the whole new row. The step reads one slice and writes the
// other, so no lane can overwrite a word another lane has still to read.
__device__ __forceinline__ void gather_step(const int32_t* from, int32_t* to, const int (&src)[kColsPerLane],
                                            int lane) {
  int32_t g[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) g[j] = from[src[j]];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) to[lane + 32 * j] = g[j] ^ 1;
  __syncwarp();
}

__global__ void __launch_bounds__(32)
gather_chain_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out, int iters) {
  __shared__ int32_t slice[2][kLanes];  // the CTA's row, double-buffered
  const int lane = threadIdx.x, row = blockIdx.x * kLanes;
  int src[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    slice[0][lane + 32 * j] = x[row + lane + 32 * j];
    src[j] = idx[row + lane + 32 * j] & (kLanes - 1);
  }
  __syncwarp();
  for (int it = 0; it < iters; ++it) gather_step(slice[it & 1], slice[(it & 1) ^ 1], src, lane);
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) out[row + lane + 32 * j] = slice[iters & 1][lane + 32 * j];
}

__global__ void __launch_bounds__(kEwThreads)
ew_chain_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                int32_t* __restrict__ out, int iters) {
  const int at = blockIdx.x * kEwThreads + threadIdx.x;
  uint32_t v = static_cast<uint32_t>(x[at]);
  const uint32_t i = static_cast<uint32_t>(idx[at]);
  for (int it = 0; it < iters; ++it) v = (v + i) ^ 1u;
  out[at] = static_cast<int32_t>(v);
}

__device__ __forceinline__ uint32_t plus_one(int32_t a) { return static_cast<uint32_t>(a) + 1u; }

__device__ __forceinline__ int4 plus_one4(int4 a) {
  return make_int4(static_cast<int>(plus_one(a.x)), static_cast<int>(plus_one(a.y)),
                   static_cast<int>(plus_one(a.z)), static_cast<int>(plus_one(a.w)));
}

// Each thread keeps kCopyInFlight 16-byte loads in flight before its
// stores. n4 + kCopyInFlight * (the grid's threads) < 2^31 (the entry checks).
__global__ void __launch_bounds__(kCopyThreads)
copy_rows_kernel(const int4* __restrict__ x, int4* __restrict__ out, int n4, int broadcast) {
  const int step = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (broadcast) {
    for (; i < n4; i += step) out[i] = x[i & (kLanes / 4 - 1)];
    return;
  }
  for (; i + (kCopyInFlight - 1) * step < n4; i += kCopyInFlight * step) {
    int4 a[kCopyInFlight];
#pragma unroll
    for (int k = 0; k < kCopyInFlight; ++k) a[k] = x[i + k * step];
#pragma unroll
    for (int k = 0; k < kCopyInFlight; ++k) out[i + k * step] = plus_one4(a[k]);
  }
  for (; i < n4; i += step) out[i] = plus_one4(x[i]);
}

__global__ void __launch_bounds__(kMixThreads)
mix_rounds_kernel(const int32_t* __restrict__ x, uint32_t* __restrict__ out, int rows, int iters,
                  int from_row0) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(rows) * kLanes) return;
  const int r = static_cast<int>(i / kLanes), l = static_cast<int>(i % kLanes);
  uint32_t v = from_row0 ? static_cast<uint32_t>(x[l]) + static_cast<uint32_t>(r)
                         : static_cast<uint32_t>(x[i]);
  for (int it = 0; it < iters; ++it) {
    const uint32_t shifted = static_cast<uint32_t>(static_cast<int32_t>(v) >> 3);
    v = (v * kMul) ^ shifted;
  }
  atomicAdd(&out[(r & 7) * kLanes + l], v);
}

}  // namespace

// The gather chain on one (128, 128) int32 plane: x and idx in, the final
// plane out (all three [128, 128]); idx is read as idx & 127.
extern "C" int pim_probe_gather_chain(const void* x, const void* idx, void* out, int iters,
                                      int device, void* stream) {
  if (iters < 0) return cudaErrorInvalidValue;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  gather_chain_kernel<<<kPlaneRows, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx), static_cast<int32_t*>(out),
      iters);
  return static_cast<int>(cudaGetLastError());
}

// The elementwise chain on the same shapes.
extern "C" int pim_probe_ew_chain(const void* x, const void* idx, void* out, int iters, int device,
                                  void* stream) {
  if (iters < 0) return cudaErrorInvalidValue;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  ew_chain_kernel<<<kPlaneRows * kLanes / kEwThreads, kEwThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx), static_cast<int32_t*>(out),
      iters);
  return static_cast<int>(cudaGetLastError());
}

// x int32 [in_rows, 128] -> out int32 [out_rows, 128]: x[0:out_rows] + 1
// when out_rows <= in_rows, else row 0 of x in every row.
extern "C" int pim_probe_copy_rows(const void* x, void* out, int in_rows, int out_rows, int device,
                                   void* stream) {
  if (in_rows <= 0 || out_rows < 0) return cudaErrorInvalidValue;
  if (out_rows == 0) return 0;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  const int64_t n4 = static_cast<int64_t>(out_rows) * (kLanes / 4);
  const int64_t per_block = static_cast<int64_t>(kCopyThreads) * kCopyInFlight;  // vectors a block covers in one pass
  const int64_t want = (n4 + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < kCopyMaxBlocks ? want : kCopyMaxBlocks);
  // 32-bit indices: the last index a thread forms stays below n4 plus
  // kCopyInFlight strides. The wrapper's out_rows < 2^31 / 128 keeps n4
  // below 2^29, far inside this.
  if (n4 + static_cast<int64_t>(kCopyInFlight) * blocks * kCopyThreads >= (int64_t{1} << 31)) {
    return cudaErrorInvalidValue;
  }
  copy_rows_kernel<<<blocks, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out), static_cast<int>(n4), out_rows > in_rows ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The recurrence over rows x 128 elements, folded into out uint32 [8, 128],
// which the caller zeroes. from_row0 = 0: the plane starts at x int32
// [rows, 128]; 1: at x[0, l] + r (x int32 [>= 1, 128]). rows % 8 == 0.
extern "C" int pim_probe_mix_rounds(const void* x, void* out, int rows, int iters, int from_row0,
                                    int device, void* stream) {
  if (rows <= 0 || rows % 8 || iters < 0) return cudaErrorInvalidValue;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  const int64_t n = static_cast<int64_t>(rows) * kLanes;
  const int blocks = static_cast<int>((n + kMixThreads - 1) / kMixThreads);
  mix_rounds_kernel<<<blocks, kMixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<uint32_t*>(out), rows, iters, from_row0);
  return static_cast<int>(cudaGetLastError());
}
