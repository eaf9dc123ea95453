// Native host codec for the block-parallel modified-Snappy format.
//
// This is the framework's fast sequential/threaded host path — the role the
// reference's host codec plays (snappy_compress.c:455-485,
// snappy_decompress.c:218-289) — written fresh in C++17. Blocks are
// independent by construction, so both directions optionally fan out across
// std::thread workers (the reference host path is single-threaded; its
// parallelism lives only on the DPUs).
//
// Exported C ABI (consumed via ctypes from pim_compression_tpu_torch.native):
//   stpu_max_compressed_length, stpu_compress, stpu_decompress,
//   stpu_peek_header, stpu_scan_frames.
// All entry points return >= 0 on success (byte/block counts) or a negative
// StatusCode on failure.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace stpu {

// ---------------------------------------------------------------------------
// Status codes (mirrors the reference's snappy_status, dpu_snappy.h:21-25).
// ---------------------------------------------------------------------------
enum StatusCode : int64_t {
  kOk = 0,
  kInvalidInput = -1,
  kBufferTooSmall = -2,
  kBadArgument = -3,
};

// ---------------------------------------------------------------------------
// Format constants (SURVEY.md §2.4).
// ---------------------------------------------------------------------------
constexpr uint32_t kTagLiteral = 0;
constexpr uint32_t kTagCopy1 = 1;
constexpr uint32_t kTagCopy2 = 2;
constexpr uint32_t kTagCopy4 = 3;
constexpr uint32_t kInputMargin = 15;
constexpr uint32_t kHashMul = 0x1e35a7bd;
constexpr uint32_t kMaxHashBits = 14;
constexpr uint32_t kMinHashEntries = 256;
constexpr uint32_t kMaxBlockSize = 64 * 1024;

inline int64_t MaxCompressedLength(int64_t n) { return 32 + n + n / 6; }

inline uint32_t Load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/ARM/TPU hosts)
  return v;
}

inline void Store32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }

// ---------------------------------------------------------------------------
// Varint32.
// ---------------------------------------------------------------------------
inline uint8_t* WriteVarint32(uint8_t* dst, uint32_t v) {
  while (v >= 0x80) {
    *dst++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *dst++ = static_cast<uint8_t>(v);
  return dst;
}

// Returns bytes consumed, or 0 on error.
inline int ReadVarint32(const uint8_t* src, const uint8_t* end, uint32_t* out) {
  uint32_t v = 0;
  for (int i = 0; i < 5 && src + i < end; ++i) {
    v |= static_cast<uint32_t>(src[i] & 0x7f) << (7 * i);
    if (!(src[i] & 0x80)) {
      *out = v;
      return i + 1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Block compressor. Bit-exact with the oracle/reference emit rules so the
// whole framework agrees on a single canonical host byte stream.
// ---------------------------------------------------------------------------
class BlockCompressor {
 public:
  BlockCompressor() : table_(1u << kMaxHashBits, 0) {}

  // Compresses in[0, n) into dst; returns bytes written.
  size_t Compress(const uint8_t* in, uint32_t n, uint8_t* dst) {
    uint32_t entries = kMinHashEntries;
    while (entries < (1u << kMaxHashBits) && entries < n) entries <<= 1;
    std::fill(table_.begin(), table_.begin() + entries, 0);
    shift_ = 32 - Log2(entries);

    uint8_t* op = dst;
    uint32_t next_emit = 0;

    if (n >= kInputMargin) {
      const uint32_t limit = n - kInputMargin;
      uint32_t ip = 1;
      uint32_t next_hash = Hash(Load32(in + ip));
      for (;;) {
        // Probe with widening stride (skip++ >> 5) until a 4-byte match.
        uint32_t skip = 32;
        uint32_t next_ip = ip;
        uint32_t candidate;
        for (;;) {
          ip = next_ip;
          const uint32_t h = next_hash;
          next_ip = ip + (skip++ >> 5);
          if (next_ip > limit) goto remainder;
          next_hash = Hash(Load32(in + next_ip));
          candidate = table_[h];
          table_[h] = static_cast<uint16_t>(ip);
          if (Load32(in + ip) == Load32(in + candidate)) break;
        }

        op = EmitLiteral(op, in + next_emit, ip - next_emit);

        // Chained copies; refresh two table slots per copy.
        uint32_t tail;
        for (;;) {
          const uint32_t base = ip;
          const uint32_t matched =
              4 + MatchLength(in, candidate + 4, ip + 4, n);
          ip += matched;
          op = EmitCopy(op, base - candidate, matched);
          tail = ip - 1;
          next_emit = ip;
          if (ip >= limit) goto remainder;
          table_[Hash(Load32(in + tail))] = static_cast<uint16_t>(ip - 1);
          const uint32_t h = Hash(Load32(in + ip));
          candidate = table_[h];
          const uint32_t cand_bytes = Load32(in + candidate);
          table_[h] = static_cast<uint16_t>(ip);
          if (Load32(in + ip) != cand_bytes) break;
        }
        next_hash = Hash(Load32(in + tail + 2));
        ++ip;
      }
    }
  remainder:
    if (next_emit < n) op = EmitLiteral(op, in + next_emit, n - next_emit);
    return static_cast<size_t>(op - dst);
  }

 private:
  static uint32_t Log2(uint32_t pow2) {
    uint32_t r = 0;
    while (pow2 > 1) {
      pow2 >>= 1;
      ++r;
    }
    return r;
  }

  uint32_t Hash(uint32_t bytes) const { return (bytes * kHashMul) >> shift_; }

  static uint32_t MatchLength(const uint8_t* in, uint32_t s1, uint32_t s2,
                              uint32_t end) {
    uint32_t matched = 0;
    while (s2 + 4 <= end && Load32(in + s2) == Load32(in + s1 + matched)) {
      s2 += 4;
      matched += 4;
    }
    while (s2 < end && in[s1 + matched] == in[s2]) {
      ++s2;
      ++matched;
    }
    return matched;
  }

  static uint8_t* EmitLiteral(uint8_t* op, const uint8_t* data, uint32_t len) {
    uint32_t n = len - 1;
    if (n < 60) {
      *op++ = kTagLiteral | (n << 2);
    } else {
      uint8_t* tag = op++;
      uint32_t count = 0;
      while (n > 0) {
        *op++ = n & 0xff;
        n >>= 8;
        ++count;
      }
      *tag = kTagLiteral | ((59 + count) << 2);
    }
    std::memcpy(op, data, len);
    return op + len;
  }

  static uint8_t* EmitCopyUpTo64(uint8_t* op, uint32_t offset, uint32_t len) {
    if (len < 12 && offset < 2048) {
      *op++ = kTagCopy1 | ((len - 4) << 2) | ((offset >> 8) << 5);
      *op++ = offset & 0xff;
    } else {
      *op++ = kTagCopy2 | ((len - 1) << 2);
      *op++ = offset & 0xff;
      *op++ = (offset >> 8) & 0xff;
    }
    return op;
  }

  static uint8_t* EmitCopy(uint8_t* op, uint32_t offset, uint32_t len) {
    while (len >= 68) {
      op = EmitCopyUpTo64(op, offset, 64);
      len -= 64;
    }
    if (len > 64) {
      op = EmitCopyUpTo64(op, offset, 60);
      len -= 60;
    }
    return EmitCopyUpTo64(op, offset, len);
  }

  std::vector<uint16_t> table_;
  uint32_t shift_ = 0;
};

// ---------------------------------------------------------------------------
// Block decompressor.
// ---------------------------------------------------------------------------
// Decodes one block payload into out[0, out_cap); backreferences validated
// per block (the DPU decoder's per-region rule,
// dpu-decompress/dpu_decompress.c:174-178). Returns bytes written or < 0.
int64_t DecompressBlock(const uint8_t* in, size_t n, uint8_t* out,
                        size_t out_cap) {
  size_t ip = 0;
  size_t op = 0;
  while (ip < n) {
    const uint8_t tag = in[ip++];
    const uint32_t kind = tag & 3;
    if (kind == kTagLiteral) {
      uint32_t lf = tag >> 2;
      size_t len;
      if (lf < 60) {
        len = lf + 1;
      } else {
        const uint32_t count = lf - 59;
        if (ip + count > n) return kInvalidInput;
        uint32_t v = 0;
        for (uint32_t i = 0; i < count; ++i) v |= in[ip + i] << (8 * i);
        ip += count;
        len = static_cast<size_t>(v) + 1;
      }
      if (ip + len > n || op + len > out_cap) return kInvalidInput;
      std::memcpy(out + op, in + ip, len);
      ip += len;
      op += len;
    } else {
      uint32_t len, offset;
      if (kind == kTagCopy1) {
        if (ip + 1 > n) return kInvalidInput;
        len = ((tag >> 2) & 7) + 4;
        offset = (static_cast<uint32_t>(tag >> 5) << 8) | in[ip];
        ip += 1;
      } else if (kind == kTagCopy2) {
        if (ip + 2 > n) return kInvalidInput;
        len = ((tag >> 2) & 0x3f) + 1;
        offset = in[ip] | (in[ip + 1] << 8);
        ip += 2;
      } else {
        if (ip + 4 > n) return kInvalidInput;
        len = ((tag >> 2) & 0x3f) + 1;
        offset = Load32(in + ip);
        ip += 4;
      }
      if (offset == 0 || offset > op || op + len > out_cap)
        return kInvalidInput;
      // Forward byte order: offset < len replicates runs (RLE semantics,
      // snappy_decompress.c:174-181). memcpy only when regions are disjoint.
      if (offset >= len) {
        std::memcpy(out + op, out + op - offset, len);
        op += len;
      } else {
        size_t src = op - offset;
        for (uint32_t i = 0; i < len; ++i) out[op++] = out[src++];
      }
    }
  }
  return static_cast<int64_t>(op);
}

// ---------------------------------------------------------------------------
// Frame walking.
// ---------------------------------------------------------------------------
struct Frame {
  int64_t payload_off;
  uint32_t payload_size;
  int64_t out_off;
  uint32_t out_size;
};

// Parses header + all block frames. Returns kOk or an error.
int64_t ScanFrames(const uint8_t* in, int64_t n, uint32_t* total_len,
                   uint32_t* block_size, std::vector<Frame>* frames) {
  const uint8_t* end = in + n;
  int used = ReadVarint32(in, end, total_len);
  if (!used) return kInvalidInput;
  int64_t pos = used;
  used = ReadVarint32(in + pos, end, block_size);
  if (!used) return kInvalidInput;
  pos += used;
  if (*block_size == 0 || *block_size > kMaxBlockSize) return kInvalidInput;
  int64_t out_off = 0;
  while (pos < n) {
    // Reject trailing frames once the output is complete (a zero-payload
    // frame appended after the last real block is malformed; the compressor
    // never emits one — empty inputs get a header and zero frames).
    if (out_off == *total_len) return kInvalidInput;
    if (pos + 4 > n) return kInvalidInput;
    const uint32_t size = Load32(in + pos);
    pos += 4;
    if (pos + size > n) return kInvalidInput;
    const uint32_t out_size = static_cast<uint32_t>(
        std::min<int64_t>(*block_size, *total_len - out_off));
    frames->push_back(Frame{pos, size, out_off, out_size});
    pos += size;
    out_off += out_size;
  }
  if (out_off != *total_len) return kInvalidInput;
  return kOk;
}

// ---------------------------------------------------------------------------
// Threaded fan-out helper: runs fn(i) for i in [0, count) on up to
// num_threads workers (block independence makes this trivially safe).
// ---------------------------------------------------------------------------
template <typename Fn>
void ParallelFor(int64_t count, int num_threads, Fn fn) {
  if (num_threads <= 1 || count <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  const int workers =
      static_cast<int>(std::min<int64_t>(num_threads, count));
  std::atomic<int64_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (;;) {
        const int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= count) return;
        fn(i);
      }
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace stpu

// ---------------------------------------------------------------------------
// C ABI.
// ---------------------------------------------------------------------------
extern "C" {

int64_t stpu_max_compressed_length(int64_t n, uint32_t block_size) {
  // Whole-stream bound: header varints + per-block frame words + per-block
  // worst-case payloads. The per-block constant matters: for tiny block
  // sizes the 4-byte frames + 32-byte slack per block dominate, so a bound
  // in terms of n alone (10 + 32 + n + n/6) under-allocates.
  if (n < 0 || block_size == 0) return stpu::kBadArgument;
  const int64_t num_blocks = n == 0 ? 0 : (n + block_size - 1) / block_size;
  return 10 + num_blocks * (4 + stpu::MaxCompressedLength(block_size));
}

// Compress in[0, n) with the given block size; writes the framed stream to
// out. Returns bytes written. num_threads <= 1 means sequential.
int64_t stpu_compress(const uint8_t* in, int64_t n, uint32_t block_size,
                      uint8_t* out, int64_t out_cap, int num_threads) {
  if (n < 0 || block_size == 0 || block_size > stpu::kMaxBlockSize)
    return stpu::kBadArgument;
  if (out_cap < stpu_max_compressed_length(n, block_size))
    return stpu::kBufferTooSmall;

  uint8_t* op = stpu::WriteVarint32(out, static_cast<uint32_t>(n));
  op = stpu::WriteVarint32(op, block_size);

  const int64_t num_blocks = n == 0 ? 0 : (n + block_size - 1) / block_size;

  // Compress every block into its own worst-case slot, then compact. The
  // compact pass is the host-side analog of the reference's ordered
  // per-tasklet fwrite (snappy_compress.c:697-703).
  const int64_t slot = stpu::MaxCompressedLength(block_size);
  std::vector<uint8_t> slots(static_cast<size_t>(slot) * num_blocks);
  std::vector<uint32_t> sizes(num_blocks);

  stpu::ParallelFor(num_blocks, num_threads, [&](int64_t b) {
    thread_local stpu::BlockCompressor comp;
    const int64_t off = b * block_size;
    const uint32_t len =
        static_cast<uint32_t>(std::min<int64_t>(block_size, n - off));
    sizes[b] = static_cast<uint32_t>(
        comp.Compress(in + off, len, slots.data() + b * slot));
  });

  for (int64_t b = 0; b < num_blocks; ++b) {
    stpu::Store32(op, sizes[b]);
    op += 4;
    std::memcpy(op, slots.data() + b * slot, sizes[b]);
    op += sizes[b];
  }
  return op - out;
}

// Reads the stream header. On success fills total_len/block_size/num_blocks
// and returns kOk.
int64_t stpu_peek_header(const uint8_t* in, int64_t n, uint32_t* total_len,
                         uint32_t* block_size, int64_t* num_blocks) {
  std::vector<stpu::Frame> frames;
  const int64_t st = stpu::ScanFrames(in, n, total_len, block_size, &frames);
  if (st != stpu::kOk) return st;
  *num_blocks = static_cast<int64_t>(frames.size());
  return stpu::kOk;
}

// Host pre-pass for the TPU decode path: walks frames and emits, per block,
// the payload offset/size and output offset/size. Arrays must hold
// max_frames entries. Returns the block count.
int64_t stpu_scan_frames(const uint8_t* in, int64_t n, int64_t* payload_off,
                         uint32_t* payload_size, int64_t* out_off,
                         uint32_t* out_size, int64_t max_frames) {
  uint32_t total_len, block_size;
  std::vector<stpu::Frame> frames;
  const int64_t st = stpu::ScanFrames(in, n, &total_len, &block_size, &frames);
  if (st != stpu::kOk) return st;
  if (static_cast<int64_t>(frames.size()) > max_frames)
    return stpu::kBufferTooSmall;
  for (size_t i = 0; i < frames.size(); ++i) {
    payload_off[i] = frames[i].payload_off;
    payload_size[i] = frames[i].payload_size;
    out_off[i] = frames[i].out_off;
    out_size[i] = frames[i].out_size;
  }
  return static_cast<int64_t>(frames.size());
}

// Pack framed payloads into padded [num_blocks, cap] row slots — the TPU
// decode path's host pre-phase (the NumPy ragged gather in
// runtime/pipeline.py touched every payload byte through fancy indexing;
// this is one memcpy per block, fanned out like the codec itself). Rows
// must arrive zeroed (np.zeros); only payload bytes are written.
// num_rows covers the padded slot matrix; rows >= num_blocks carry no
// payload. dirty_bytes marks how far a REUSED staging buffer may hold stale
// bytes from a previous call: payload-row tails and empty rows are memset
// only up to that watermark, so a fresh calloc'd buffer (dirty_bytes = 0)
// pays zero memset for its untouched padding pages.
int64_t stpu_blockize_compressed(const uint8_t* in, int64_t n,
                                 const int64_t* payload_off,
                                 const uint32_t* payload_size,
                                 int64_t num_blocks, int64_t num_rows,
                                 int64_t cap, int64_t dirty_bytes,
                                 uint8_t* comp, int num_threads) {
  std::atomic<int64_t> status{stpu::kOk};
  stpu::ParallelFor(num_rows, num_threads, [&](int64_t b) {
    uint8_t* row = comp + b * cap;
    const int64_t row_off = b * cap;
    int64_t size = 0;
    if (b < num_blocks) {
      const int64_t off = payload_off[b];
      size = payload_size[b];
      if (off < 0 || size > cap || off + size > n) {
        status.store(stpu::kInvalidInput);
        return;
      }
      std::memcpy(row, in + off, static_cast<size_t>(size));
    }
    const int64_t zero_hi =
        std::min<int64_t>(cap, dirty_bytes - row_off);
    if (zero_hi > size)
      std::memset(row + size, 0, static_cast<size_t>(zero_hi - size));
  });
  return status.load();
}

// Plain chunked parallel memcpy: the host-side byte moves that remain after
// the blockize/assemble entry points (plain-input blockize, decompressed
// assembly) are single contiguous copies — fan them out so the host phases
// track aggregate memory bandwidth, not one core's.
int64_t stpu_parallel_copy(uint8_t* dst, const uint8_t* src, int64_t n,
                           int num_threads) {
  constexpr int64_t kChunk = 4 << 20;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  stpu::ParallelFor(chunks, num_threads, [&](int64_t c) {
    const int64_t off = c * kChunk;
    std::memcpy(dst + off, src + off,
                static_cast<size_t>(std::min(kChunk, n - off)));
  });
  return n;
}

// Compact padded per-block payloads into the framed stream tail (u32 frame
// word + payload per block), written at out — the encode path's host
// post-phase, the ordered-fwrite analog (snappy_compress.c:697-703), one
// memcpy per block in parallel. Returns bytes written.
int64_t stpu_assemble_compressed(const uint8_t* comp, int64_t cap,
                                 const uint32_t* sizes, int64_t num_blocks,
                                 uint8_t* out, int64_t out_cap,
                                 int num_threads) {
  std::vector<int64_t> offs(static_cast<size_t>(num_blocks) + 1);
  offs[0] = 0;
  for (int64_t b = 0; b < num_blocks; ++b) {
    if (sizes[b] > cap) return stpu::kInvalidInput;
    offs[b + 1] = offs[b] + 4 + sizes[b];
  }
  if (offs[num_blocks] > out_cap) return stpu::kBufferTooSmall;
  stpu::ParallelFor(num_blocks, num_threads, [&](int64_t b) {
    uint8_t* op = out + offs[b];
    stpu::Store32(op, sizes[b]);
    std::memcpy(op + 4, comp + b * cap, sizes[b]);
  });
  return offs[num_blocks];
}

// Decompress a framed stream. Returns bytes written.
int64_t stpu_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t out_cap, int num_threads) {
  uint32_t total_len, block_size;
  std::vector<stpu::Frame> frames;
  const int64_t st = stpu::ScanFrames(in, n, &total_len, &block_size, &frames);
  if (st != stpu::kOk) return st;
  if (out_cap < total_len) return stpu::kBufferTooSmall;

  std::atomic<int64_t> status{stpu::kOk};
  stpu::ParallelFor(
      static_cast<int64_t>(frames.size()), num_threads, [&](int64_t b) {
        const stpu::Frame& f = frames[b];
        const int64_t got = stpu::DecompressBlock(
            in + f.payload_off, f.payload_size, out + f.out_off, f.out_size);
        if (got != f.out_size) status.store(stpu::kInvalidInput);
      });
  if (status.load() != stpu::kOk) return status.load();
  return total_len;
}

}  // extern "C"
