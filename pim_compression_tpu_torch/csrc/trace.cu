// %globaltimer against the host's clock, for the traced kernels' spans
// (trace.cuh, runtime/profiling.py).
//
// A one-thread kernel on a stream of its own and the host take turns through
// a word of mapped host memory: the kernel says it is ready, the host reads
// its clock and tells it to go, the kernel reads %globaltimer and says it is
// done, and the host reads its clock again. The kernel's reading lies between
// the two host readings, so their midpoint, give or take half their distance,
// is the host time of that %globaltimer value. Queued work ahead of the probe
// only delays its start, not a turn. Each wait is bounded on both sides, so a
// probe that never starts or a host that stops answering ends the call.
// The probe also reads %globaltimer at its first and last instruction: a
// profiler that records the probe as a kernel event shows where its own device
// timeline puts those two readings (profiling.add_kernel_spans aligns on it).

#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

#include "trace.cuh"

namespace {

constexpr int kMaxTries = 64;
constexpr int kMaxDevices = 64;
constexpr unsigned long long kDeviceWaitNs = 100000000ull;  // the probe waits 100 ms at most for go
constexpr long long kHostWaitNs = 2000000000ll;             // the host waits 2 s at most for the probe

struct Probe {
  int go;     // host: try i may read the clock once go > i
  int state;  // probe: 2 i + 1 ready for try i, 2 i + 2 done with it
  unsigned long long begin, finish;  // the probe's first and last reading
  unsigned long long stamp[kMaxTries];
};

__global__ void clock_probe_kernel(volatile Probe* probe, int tries) {
  probe->begin = pim::globaltimer();
  for (int i = 0; i < tries; ++i) {
    probe->state = 2 * i + 1;
    __threadfence_system();
    const unsigned long long since = pim::globaltimer();
    bool late = false;
    while (probe->go <= i && !late) late = pim::globaltimer() - since > kDeviceWaitNs;
    if (late) break;
    probe->stamp[i] = pim::globaltimer();
    __threadfence_system();
    probe->state = 2 * i + 2;
    __threadfence_system();
  }
  probe->finish = pim::globaltimer();
}

long long host_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<long long>(ts.tv_sec) * 1000000000ll + ts.tv_nsec;
}

bool wait_for(volatile int* word, int want) {
  const long long since = host_ns();
  while (*word != want) {
    if (host_ns() - since > kHostWaitNs) return false;
  }
  return true;
}

// Per device: the probe's mapped word (host and device addresses) and its stream, made once.
Probe* g_host[kMaxDevices];
Probe* g_dev[kMaxDevices];
cudaStream_t g_stream[kMaxDevices];

}  // namespace

// Calibrate %globaltimer of `device` against CLOCK_REALTIME: out[3 i],
// out[3 i + 1], out[3 i + 2] = host ns before, %globaltimer ns, host ns after,
// for tries i = 0 .. tries - 1; out[3 tries], out[3 tries + 1] = the probe's
// first and last %globaltimer reading. Returns the tries made (fewer where a
// wait ran out), or minus the CUDA error.
extern "C" int pim_clock_calibrate(int device, int tries, long long* out) {
  if (tries <= 0 || tries > kMaxTries || device < 0 || device >= kMaxDevices || out == nullptr) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t st = cudaSetDevice(device);
  if (st != cudaSuccess) return -static_cast<int>(st);
  if (g_host[device] == nullptr) {
    void* host = nullptr;
    void* dev = nullptr;
    int lo = 0, hi = 0;
    st = cudaHostAlloc(&host, sizeof(Probe), cudaHostAllocMapped | cudaHostAllocPortable);
    if (st == cudaSuccess) st = cudaHostGetDevicePointer(&dev, host, 0);
    if (st == cudaSuccess) st = cudaDeviceGetStreamPriorityRange(&lo, &hi);
    if (st == cudaSuccess) st = cudaStreamCreateWithPriority(&g_stream[device], cudaStreamNonBlocking, hi);
    if (st != cudaSuccess) return -static_cast<int>(st);
    g_host[device] = static_cast<Probe*>(host);
    g_dev[device] = static_cast<Probe*>(dev);
  }
  volatile Probe* probe = g_host[device];
  probe->go = 0;
  probe->state = 0;
  clock_probe_kernel<<<1, 1, 0, g_stream[device]>>>(g_dev[device], tries);
  st = cudaGetLastError();
  if (st != cudaSuccess) return -static_cast<int>(st);
  int done = 0;
  for (int i = 0; i < tries; ++i) {
    if (!wait_for(&probe->state, 2 * i + 1)) break;
    const long long before = host_ns();
    probe->go = i + 1;
    if (!wait_for(&probe->state, 2 * i + 2)) break;
    const long long after = host_ns();
    out[3 * i] = before;
    out[3 * i + 1] = static_cast<long long>(probe->stamp[i]);
    out[3 * i + 2] = after;
    done = i + 1;
  }
  probe->go = tries + 1;  // a probe still waiting goes on and ends
  st = cudaStreamSynchronize(g_stream[device]);
  if (st != cudaSuccess) return -static_cast<int>(st);
  out[3 * tries] = static_cast<long long>(probe->begin);
  out[3 * tries + 1] = static_cast<long long>(probe->finish);
  return done;
}
