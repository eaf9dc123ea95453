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
// Design: one warp per block, kWarps warps to a CTA and no CTA-wide barrier,
// so a 1024-block batch is about 8 warps on each of the 132 SMs, every walk
// resident at once, at every block size up to 65536. Each warp walks the
// greedy parse the way a serial compressor does. At an accepted position
// whose deferred length is 4 or more, lanes 0-2 write the 2- or 3-byte copy
// tag. Otherwise a literal run starts there; the warp finds its end (the
// next position with a deferred length of 4 or more, or the block's length)
// 32 positions at a time with a ballot, and the 32 lanes write its 1-3
// header bytes and its bytes, 32 a step. The TPU's accept scan, prefix sum
// and token routing exist because a TPU lane cannot address memory at will;
// a serial walk gives every element its output offset directly.
//
// Shared memory, per warp: a window of kWindow positions of the walk's
// inputs (the block's bytes, zero at and past lens[b]; the match lengths and
// the lags, zero at and past block_size, the lags' int16 bits read unsigned:
// a 64 KB block's lags reach 65535, and a COPY_2 carries 16 offset bits), and
// an output ring of two kHalf-byte halves. 6144 bytes a warp, 24576 a CTA,
// whatever the block size or cap. The walk reads only the window, so no
// device-memory load is in its chain: when the cursor p (which reads p and
// p + 1) or the literal scan's q (which reads q .. q + 32) would leave it,
// the warp restages the window from cursor & ~15 with 16-byte loads between
// two __syncwarp()s; a literal run's bytes go out 32 a step, and where the
// scan's restaging has passed the run's first bytes (a run longer than the
// window), or a step's bytes run past the window, it is restaged at them.
// When the output cursor passes a half, the warp writes that half to the row
// in 16-byte stores (byte stores for an unaligned cap or row), clipped at
// cap: bytes at or past cap are never written, and sizes[b] still gives the
// full size, which the runtime's overflow check reads. At the end the
// partial half, zeroed past the size, and zeros up to cap follow, so the
// wrapper allocates with torch.empty. The restaging and the ring writes are
// out of line (__noinline__), which keeps the walk's loop small.
// tests/test_torch_emit_window.py holds a NumPy mirror of this walk (the
// window, its refill rules and margins, the ring and its clipped flushes)
// against the plain version and the spec.
//
// What bounds it: the serial walk of each batch's slowest block, a chain of
// dependent instructions per element, on one warp that has nothing else to
// issue. On an H100 a copy costs about 230 cycles and a one-byte literal run
// about 650 (scripts/emit_time.py's fixed parses), the 16-byte restages
// little (a window of 2048 moved nothing). The card's bound (bytes over the
// memory rate) is an order of magnitude below the walk; shortening the chain
// (the scan's stop bits and the deferred lengths computed while staging) or
// a parallel parse would be the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWindow = 1024;  // positions staged per warp
constexpr int kHalf = 1024;    // bytes in each half of a warp's output ring
constexpr int kRingMask = 2 * kHalf - 1;
constexpr int kCopyMargin = 2;   // the cursor reads p and p + 1
constexpr int kScanMargin = 33;  // a scan step reads q .. q + 32
constexpr int kMaxBlockSize = 65536;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kWindow % 512 == 0, "each lane stages whole 16-byte pieces");
static_assert((kHalf & (kHalf - 1)) == 0 && kHalf >= 512, "a power of two, 16-byte pieces for 32 lanes");

struct WarpShared {
  uint16_t lag[kWindow];
  uint8_t data[kWindow];
  uint8_t len[kWindow];
  uint8_t ring[2 * kHalf];
};

// The 16 bytes of src[at, at + 16 / sizeof(T)), with elements at and past
// limit zero; nothing at or past src[limit] is read.
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* src, int at, int limit) {
  constexpr int kCount = 16 / sizeof(T);
  if (at + kCount <= limit && (reinterpret_cast<uintptr_t>(src + at) & 15) == 0) {
    return *reinterpret_cast<const uint4*>(src + at);
  }
  uint64_t half[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < kCount; ++k) {
    const int shift = 8 * sizeof(T) * (k % (kCount / 2));
    if (at + k < limit) half[2 * k / kCount] |= static_cast<uint64_t>(src[at + k]) << shift;
  }
  return make_uint4(static_cast<uint32_t>(half[0]), static_cast<uint32_t>(half[0] >> 32),
                    static_cast<uint32_t>(half[1]), static_cast<uint32_t>(half[1] >> 32));
}

// Stage positions [base, base + kWindow) of the block: all loads first, then
// the stores, between two __syncwarp()s (the old window's last reads before,
// the new one's first reads after).
__device__ __noinline__ void stage(WarpShared& s, const uint8_t* data, const uint8_t* len,
                                   const uint16_t* lag, int base, int n, int bs, int lane) {
  constexpr int kBytePieces = kWindow / 16 / 32;
  constexpr int kLagPieces = kWindow / 8 / 32;
  uint4 d[kBytePieces], l[kBytePieces], g[kLagPieces];
#pragma unroll
  for (int k = 0; k < kBytePieces; ++k) {
    const int at = base + 16 * (lane + 32 * k);
    d[k] = load_piece(data, at, n);
    l[k] = load_piece(len, at, bs);
  }
#pragma unroll
  for (int k = 0; k < kLagPieces; ++k) g[k] = load_piece(lag, base + 8 * (lane + 32 * k), bs);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kBytePieces; ++k) {
    reinterpret_cast<uint4*>(s.data)[lane + 32 * k] = d[k];
    reinterpret_cast<uint4*>(s.len)[lane + 32 * k] = l[k];
  }
#pragma unroll
  for (int k = 0; k < kLagPieces; ++k) reinterpret_cast<uint4*>(s.lag)[lane + 32 * k] = g[k];
  __syncwarp();
}

// Write ring half `start` (output bytes [start, start + kHalf)) to the row,
// clipped at cap, between two __syncwarp()s (the ring's writes before, its
// next writes after).
__device__ __noinline__ void write_half(const WarpShared& s, uint8_t* out, int start, int cap,
                                        bool vec, int lane) {
  __syncwarp();
  const uint8_t* src = s.ring + (start & kRingMask);
  if (vec) {  // cap and the row are 16-byte aligned, so a piece is all below cap or all past it
    for (int c = lane; c < kHalf / 16; c += 32) {
      if (start + 16 * c < cap) {
        reinterpret_cast<uint4*>(out + start)[c] = reinterpret_cast<const uint4*>(src)[c];
      }
    }
  } else {
    for (int c = lane; c < kHalf; c += 32) {
      if (start + c < cap) out[start + c] = src[c];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
emit_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                   const uint8_t* __restrict__ mlen, const uint16_t* __restrict__ mlag,
                   uint8_t* __restrict__ comp, int32_t* __restrict__ sizes, int num_blocks, int bs,
                   int cap) {
  __shared__ WarpShared shared[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= num_blocks) return;
  WarpShared& s = shared[warp];

  const int n = min(max(lens[b], 0), bs);
  const size_t row = static_cast<size_t>(b) * bs;
  const uint8_t* data = blocks + row;
  const uint8_t* len = mlen + row;
  const uint16_t* lag = mlag + row;
  uint8_t* out = comp + static_cast<size_t>(b) * cap;
  const bool vec = (cap & 15) == 0 && (reinterpret_cast<uintptr_t>(comp) & 15) == 0;

  int base = 0;  // the window holds positions [base, base + kWindow)
  stage(s, data, len, lag, base, n, bs, lane);
  int p = 0;        // next accepted position
  int o = 0;        // output size so far
  int flushed = 0;  // output bytes [0, flushed) are written to the row
  while (p < n) {
    if (p + kCopyMargin > base + kWindow) {
      base = p & ~15;
      stage(s, data, len, lag, base, n, bs, lane);
    }
    // The three window loads of position p, issued together.
    const int i = p - base;
    const int here = s.len[i];
    const int next = s.len[i + 1];
    const uint32_t off = s.lag[i];
    const int d = next > here ? 0 : here;  // lazy_defer
    if (d >= 4) {  // copy: copy1 iff len < 12 and offset < 2048
      const bool one = d < 12 && off < 2048;
      const uint32_t tag =
          one ? 1u | (static_cast<uint32_t>(d - 4) << 2) | ((off >> 8) << 5) | ((off & 0xFF) << 8)
              : 2u | (static_cast<uint32_t>(d - 1) << 2) | ((off & 0xFF) << 8) | (((off >> 8) & 0xFF) << 16);
      const int h = one ? 2 : 3;
      if (lane < h) s.ring[(o + lane) & kRingMask] = static_cast<uint8_t>(tag >> (8 * lane));
      o += h;
      p += d;
      if (o - flushed >= kHalf) {
        write_half(s, out, flushed, cap, vec, lane);
        flushed += kHalf;
      }
      continue;
    }
    // Literal run [p, end).
    int end = n;
    for (int q = p + 1; q < n; q += 32) {
      if (q + kScanMargin > base + kWindow) {
        base = q & ~15;
        stage(s, data, len, lag, base, n, bs, lane);
      }
      const int j = q - base + lane;
      const int a = s.len[j];
      const int c = s.len[j + 1];
      const bool stop = q + lane >= n || (c > a ? 0 : a) >= 4;
      const unsigned m = __ballot_sync(kFull, stop);
      if (m) {
        end = min(q + __ffs(m) - 1, n);
        break;
      }
    }
    const int run = end - p;
    const uint32_t lit = static_cast<uint32_t>(run - 1);
    const int h = lit < 60 ? 1 : (lit < 256 ? 2 : 3);
    const uint32_t hdr = h == 1 ? lit << 2 : ((h == 2 ? 60u : 61u) << 2) | (lit << 8);
    const int total = h + run;
    // Its header and bytes, 32 output bytes a step, every lane on the same
    // path. Where the scan's restaging has passed the run's first bytes, or
    // a step's bytes run past the window, the window is restaged at them.
    for (int k = 0; k < total; k += 32) {
      const int lo = p + max(k - h, 0);             // the step's first byte of the block
      const int hi = min(p + k + 31 - h, end - 1);  // and its last
      if (lo < base || hi >= base + kWindow) {
        base = lo & ~15;
        stage(s, data, len, lag, base, n, bs, lane);
      }
      const int t = k + lane;
      const uint8_t byte = s.data[min(max(p + t - h - base, 0), kWindow - 1)];
      const uint8_t v = t < h ? static_cast<uint8_t>(hdr >> (8 * min(t, 3))) : byte;
      if (t < total) s.ring[(o + t) & kRingMask] = v;
      if (o + min(k + 32, total) - flushed >= kHalf) {
        write_half(s, out, flushed, cap, vec, lane);
        flushed += kHalf;
      }
    }
    o += total;
    p = end;
  }

  // The partial half, zero past the size, then zeros up to cap.
  __syncwarp();
  for (int t = o + lane; t < flushed + kHalf; t += 32) s.ring[t & kRingMask] = 0;
  write_half(s, out, flushed, cap, vec, lane);
  if (vec) {
    for (int c = (flushed + kHalf) / 16 + lane; c < cap / 16; c += 32) {
      reinterpret_cast<uint4*>(out)[c] = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int t = flushed + kHalf + lane; t < cap; t += 32) out[t] = 0;
  }
  if (lane == 0) sizes[b] = o;
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
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return st;
  const int grid = (num_blocks + kWarps - 1) / kWarps;
  emit_blocks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(lens),
      static_cast<const uint8_t*>(mlen), static_cast<const uint16_t*>(mlag),
      static_cast<uint8_t*>(comp), static_cast<int32_t*>(sizes), num_blocks, block_size, cap);
  return static_cast<int>(cudaGetLastError());
}
