// A measuring tool, not a kernel of the port and not a port of anything: no
// module of the package loads this library.  chip_smoke.py builds it beside
// the kernels and turns its readings into the "chain" model it prints next to
// the Hungarian kernels' times.
//
// One warp times, with clock64, a chain of kProbeIters dependent instructions
// of each kind that a Jonker-Volgenant search is made of: a shared-memory read
// whose address is the previous read's value, an f32 add, a shuffle whose
// source lane is the previous shuffle's value, and an integer warp minimum fed
// by the previous one (plus one integer add).
//
// Plain C interface, like the kernels' sources: built by ops/_build.py with
// nvcc for sm_90a, opened with ctypes.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kProbeIters = 4096;

__global__ void latency_probe_kernel(long long* __restrict__ out, int one) {
  __shared__ int ring[64];
  const int lane = threadIdx.x;
  ring[lane] = (lane + one) & 63;  // `one` is 1 at run time: nothing folds
  ring[lane + 32] = (lane + 32 + one) & 63;
  __syncwarp();

  int idx = lane;
  long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < kProbeIters; ++i) idx = ring[idx];
  long long t1 = clock64();
  const long long shared_read = t1 - t0;

  float x = static_cast<float>(lane);
  const float y = 0.5f * static_cast<float>(one);
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < kProbeIters; ++i) x += y;
  t1 = clock64();
  const long long f32_add = t1 - t0;

  int w = lane;
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < kProbeIters; ++i) w = __shfl_sync(kFull, w, (w + one) & 31);
  t1 = clock64();
  const long long shuffle = t1 - t0;

  unsigned r = static_cast<unsigned>(one);
  t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < kProbeIters; ++i) r = __reduce_min_sync(kFull, r + lane);
  t1 = clock64();
  const long long warp_min = t1 - t0;

  if (lane == 0) {
    out[0] = shared_read;
    out[1] = f32_add;
    out[2] = shuffle;
    out[3] = warp_min;
    out[4] = kProbeIters;
    out[5] = idx + static_cast<long long>(x) + w + r;  // keeps the chains alive
  }
}

}  // namespace

// Runs the probe on `stream`; out: device int64 [6]: the cycles of kProbeIters
// dependent shared-memory reads, f32 adds, shuffles and integer warp minima
// (each with one integer add), then kProbeIters, then a checksum.  Returns
// cudaGetLastError() as an int.
extern "C" int sedt_latency_probe(long long* out, void* stream) {
  latency_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, 1);
  return static_cast<int>(cudaGetLastError());
}
