// Block decode for the block-parallel modified-Snappy format, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package that decode a batch, on both
// of its paths:
//   pim_compression_tpu/ops/pallas_decode.py::_dfa_kernel          K1, parse DFA
//       (narrow, and wide=True: a 17-bit dst and an int16 value plane)
//   pim_compression_tpu/ops/pallas_decode.py::_route_kernel        K2, route/fill/resolve
//   pim_compression_tpu/ops/pallas_decode.py::_route_kernel_wide   K2 for 32 KB < bs <= 64 KB
// The TPU needs the wide path because its tokens pack a row and a value into
// one int32; a serial walk holds both in registers, so one kernel serves
// every block size.
// The TPU design (a lockstep DFA over 1024 lanes, compact/expand routing,
// prefix-max fill, pointer doubling) exists because a TPU lane has no random
// access. Hopper has it, so one CTA decodes one block the way the host
// decoder does (oracle.decompress_block): one warp walks the tags serially
// out of shared memory and copies each literal or match with its 32 lanes.
//
// What bounds it on this card: the serial tag walk. Each element is a chain
// of dependent shared-memory reads (tag, length/offset bytes) before its copy
// can start, so a block's time is its element count times that latency; the
// bytes moved (payload in, block out) are far below HBM bandwidth. The design
// keeps the walk off device memory entirely: payload and output block are
// staged in dynamic shared memory (cap + block_size: ~70 KB at 32 KB blocks,
// so three CTAs share an SM; 76544 + 65536 = 142080 bytes at 64 KB, one CTA
// per SM), the loads and the write-back are 16-byte
// coalesced, and many blocks run at once, one per CTA. Walking several blocks
// per CTA or scanning tags in parallel is left for later work.
//
// Error bits match the parse DFA (pim_compression_tpu/ops/lane_model.py:37-41,
// parse_dfa): ERR_LENGTH_MISMATCH, ERR_BAD_OFFSET and ERR_ELEMENT_OVERRUN are
// set under the DFA's conditions. ERR_ROUTE_CONFLICT and ERR_UNRESOLVED come
// from the TPU routing and resolve stages; a serial decoder has neither stage
// and cannot produce them. On a block the DFA accepts, those stages set
// nothing either, so the verdict (err != 0) is the reference's on every block.
//
// Safety on malformed input: bytes at or past comp_len are never read, nothing
// is written outside the block's output row, and all lengths stay in 32-bit
// range (a literal takes at most the bytes left in the payload).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kErrLengthMismatch = 1;
constexpr int kErrBadOffset = 2;
constexpr int kErrElementOverrun = 4;

constexpr int kThreads = 128;
constexpr int kMaxBlockSize = 65536;
constexpr size_t kMaxSharedBytes = 232448;  // per-block limit on sm_90

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// One warp decodes the staged payload s_in[0, clen) into s_out[0, block_size).
// Returns the error bits. All lanes run the same control flow; every lane
// reads the same tag bytes (a shared-memory broadcast).
__device__ int decode_warp(const uint8_t* s_in, uint8_t* s_out, int clen,
                           int olen, int block_size, int lane) {
  int err = 0;
  if (olen < 0 || olen > block_size) err |= kErrLengthMismatch;  // outside the contract
  const int wlim = min(max(olen, 0), block_size);  // writes stay below this
  int p = 0;  // payload cursor
  int o = 0;  // output cursor; may run past olen on a malformed block
  while (p < clen) {
    const uint32_t tag = s_in[p++];
    const uint32_t kind = tag & 3u;
    if (kind == 0) {  // literal
      uint32_t len = (tag >> 2) + 1;
      if (len > 60) {  // 1-4 little-endian length bytes follow
        const int n = static_cast<int>(len) - 60;
        if (p + n > clen) {  // truncated length: the DFA ends in EXT
          err |= kErrElementOverrun;
          break;
        }
        uint32_t acc = s_in[p];
        if (n > 1) acc |= static_cast<uint32_t>(s_in[p + 1]) << 8;
        if (n > 2) acc |= static_cast<uint32_t>(s_in[p + 2]) << 16;
        if (n > 3 && s_in[p + 3] != 0) err |= kErrElementOverrun;  // > 24 bits
        p += n;
        len = acc + 1;  // <= 2^24
      }
      const int avail = clen - p;
      const int take = len < static_cast<uint32_t>(avail) ? static_cast<int>(len) : avail;
      if (take > 0 && o + take > olen) err |= kErrLengthMismatch;
      const int wend = min(o + take, wlim);
      for (int i = o + lane; i < wend; i += 32) s_out[i] = s_in[p + (i - o)];
      o += take;
      p += take;
      if (static_cast<uint32_t>(take) < len) {  // payload ends inside the literal
        err |= kErrElementOverrun;
        break;
      }
    } else {  // copy with a 1-, 2- or 4-byte offset
      const int n = kind == 1 ? 1 : (kind == 2 ? 2 : 4);
      const int len = kind == 1 ? static_cast<int>((tag >> 2) & 7u) + 4
                                : static_cast<int>(tag >> 2) + 1;
      if (p + n > clen) {  // truncated offset: the DFA ends in OFF
        err |= kErrElementOverrun;
        break;
      }
      uint32_t off;
      bool high = false;  // a COPY_4 offset byte above 24 bits
      if (kind == 1) {
        off = ((tag >> 5) << 8) | s_in[p];
      } else if (kind == 2) {
        off = s_in[p] | (static_cast<uint32_t>(s_in[p + 1]) << 8);
      } else {
        off = s_in[p] | (static_cast<uint32_t>(s_in[p + 1]) << 8) |
              (static_cast<uint32_t>(s_in[p + 2]) << 16);
        high = s_in[p + 3] != 0;
      }
      p += n;
      const bool bad = off == 0 || off > static_cast<uint32_t>(o) ||
                       off > static_cast<uint32_t>(block_size) || high;
      if (bad) err |= kErrBadOffset;
      if (o + len > olen) err |= kErrLengthMismatch;
      if (!bad && o < wlim) {
        const int d = static_cast<int>(off);
        const int wend = min(o + len, wlim);
        if (d >= len) {
          for (int i = o + lane; i < wend; i += 32) s_out[i] = s_out[i - d];
        } else {
          // Overlapping copy (run-length): the output repeats with period d,
          // so byte i is s_out[o - d + (i - o) % d], all decoded before o.
          for (int i = o + lane; i < wend; i += 32) s_out[i] = s_out[o - d + (i - o) % d];
        }
      }
      o += len;
    }
    __syncwarp();  // this element's bytes are visible to every lane
  }
  if (o != olen) err |= kErrLengthMismatch;
  return err;
}

__global__ void __launch_bounds__(kThreads)
decode_blocks_kernel(const uint8_t* __restrict__ comp,
                     const int32_t* __restrict__ comp_len,
                     const int32_t* __restrict__ out_len,
                     uint8_t* __restrict__ out, int32_t* __restrict__ err,
                     int cap, int block_size) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_out = smem;                      // round16(block_size) bytes
  uint8_t* s_in = smem + round16(block_size);  // round16(cap) bytes

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int clen = min(max(comp_len[b], 0), cap);
  const uint8_t* src = comp + static_cast<size_t>(b) * cap;
  uint8_t* dst = out + static_cast<size_t>(b) * block_size;

  // Zero the output staging, so bytes a malformed block never writes read 0.
  uint4* s_out16 = reinterpret_cast<uint4*>(s_out);
  for (int i = tid; i < round16(block_size) / 16; i += kThreads) s_out16[i] = make_uint4(0, 0, 0, 0);

  // Stage the payload [0, clen): whole 16-byte words, then the tail bytes.
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = clen & ~15;
    const uint4* src16 = reinterpret_cast<const uint4*>(src);
    uint4* s_in16 = reinterpret_cast<uint4*>(s_in);
    for (int i = tid; i < head / 16; i += kThreads) s_in16[i] = src16[i];
  }
  for (int i = head + tid; i < clen; i += kThreads) s_in[i] = src[i];
  __syncthreads();

  if (tid < 32) {
    const int e = decode_warp(s_in, s_out, clen, out_len[b], block_size, tid);
    if (tid == 0) err[b] = e;
  }
  __syncthreads();

  // Write the block row back, coalesced.
  if ((block_size & 15) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    uint4* dst16 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < block_size / 16; i += kThreads) dst16[i] = s_out16[i];
  } else {
    for (int i = tid; i < block_size; i += kThreads) dst[i] = s_out[i];
  }
}

}  // namespace

// Decode num_blocks blocks on `stream`. comp is uint8[num_blocks, cap];
// comp_len, out_len and err are int32[num_blocks]; out is
// uint8[num_blocks, block_size]. Returns cudaGetLastError() after the launch
// (0 on success). Does not synchronise.
extern "C" int pim_decode_blocks(const void* comp, const void* comp_len,
                                 const void* out_len, void* out, void* err,
                                 int num_blocks, int cap, int block_size,
                                 int device, void* stream) {
  if (num_blocks <= 0) return 0;
  if (block_size <= 0 || block_size > kMaxBlockSize || cap <= 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(round16(block_size)) + round16(cap);
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  st = cudaFuncSetAttribute(decode_blocks_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem));
  if (st != cudaSuccess) return st;
  decode_blocks_kernel<<<num_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_len),
      static_cast<const int32_t*>(out_len), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(err), cap, block_size);
  return static_cast<int>(cudaGetLastError());
}
