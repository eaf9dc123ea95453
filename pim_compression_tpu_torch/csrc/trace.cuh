// The record a traced codec kernel (decode.cu, match.cu, sweep.cu, emit.cu)
// writes for one launch, read by runtime/profiling.py.
//
// Each kernel is a template on kTrace. The plain instantiation (kTrace
// false) takes a null record and compiles to the kernel without tracing;
// the traced one reduces what it counts on the device into one zeroed
// record, with a few atomics per warp (decode, emit) or per CTA (match,
// sweep), and writes nothing per position or element.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pim {

// Sixteen 64-bit words, zero before the launch. Walks (decode, emit: one a
// warp) or CTAs (match, sweep) each fold their span in; neg_start keeps ~start so
// that a max over a zeroed word gives the earliest start. Times are
// %globaltimer nanoseconds.
struct TraceRecord {
  unsigned long long neg_start;  // the largest ~start: ~ the earliest start
  unsigned long long end;        // the latest end
  unsigned long long span;       // the walks' or CTAs' durations, summed
  unsigned long long count;      // walks or CTAs
  unsigned long long c[12];      // the kernel's own counters (profiling.COUNTERS)
};

static_assert(sizeof(TraceRecord) == 128, "profiling.RECORD_WORDS words of 8 bytes");

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A walk's or CTA's span, folded in at its two ends so that nothing stays
// live between them: the start adds -start to the sum of spans (mod 2^64)
// and the end adds end, so that once every walk has ended the sum is that of
// their durations.
__device__ __forceinline__ void trace_start(TraceRecord* r, unsigned long long start) {
  atomicMax(&r->neg_start, ~start);
  atomicAdd(&r->span, 0ull - start);
}

__device__ __forceinline__ void trace_end(TraceRecord* r, unsigned long long end) {
  atomicMax(&r->end, end);
  atomicAdd(&r->span, end);
  atomicAdd(&r->count, 1ull);
}

}  // namespace pim
