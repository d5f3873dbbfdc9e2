// Chained-FMA peak probe for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/roofline.py::measure_vpu_peak (the
// Pallas kernel at :59-71, pallas_call :73): a (256, 128) float32 tile
// resident in fast memory, two independent chains of k/2 fused
// multiply-adds per element (b = b*m1 + d, c = c*m2 - d), one output per
// element per grid step.  2k floating-point operations per element; no
// memory traffic in the loop.
//
// What bounds it on this card: FP32 FMA issue, by design.  The grid of the
// TPU kernel (64 steps of the tile, each scaled by 1 + step * 1e-9 so that
// no step repeats another) becomes 64 tiles of 32768 elements, two elements
// per thread (element i and i + N/2): 1,048,576 threads, four independent
// chains in flight per thread.  Measured on the H100 (NVIDIA H100 80GB
// HBM3, 700 W, SM clock 1980 MHz throughout): one element per thread, two
// chains, issued 33.8 TFLOP/s; two elements 57.0; four 46.8 (fewer
// resident warps).  The chains are written with __fmaf_rn, so they stay
// FMAs under the port's --fmad=false.  rt_tpu_torch.roofline times k = 1024
// and 4096 and checks that 4x the chain costs 2.5-6x the time (the JAX
// probe's validity check), so launch overhead cannot pass for a peak.

#include "common.cuh"

namespace {

constexpr int kTileElems = 256 * 128;
constexpr int kFmaThreads = 256;

constexpr int kPerThread = 2;

__global__ void __launch_bounds__(kFmaThreads) fma_peak_kernel(const float* __restrict__ x,
                                                               float* __restrict__ out,
                                                               int tiles, int k_half) {
  const int half = tiles * kTileElems / kPerThread;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half) return;
  float b[kPerThread], c[kPerThread], m1[kPerThread], m2[kPerThread], d[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int gid = t + e * half;
    const int tile = gid / kTileElems;
    const float a = x[gid - tile * kTileElems] * (1.0f + static_cast<float>(tile) * 1e-9f);
    m1[e] = a * 0.4999999f + 0.5f;  // ~1.0
    m2[e] = a * 0.5000001f + 0.5f;
    d[e] = a * 1e-7f;
    b[e] = a;
    c[e] = a + d[e];
  }
#pragma unroll 8
  for (int k = 0; k < k_half; ++k) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      b[e] = __fmaf_rn(b[e], m1[e], d[e]);
      c[e] = __fmaf_rn(c[e], m2[e], -d[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) out[t + e * half] = b[e] + c[e];
}

}  // namespace

// Launches one call on `stream`; returns cudaGetLastError() as an int.
// x: (256, 128) float32; out: (tiles * 256, 128) float32.  tiles * 32768
// must be even (it is a multiple of 32768).
extern "C" int rt_fma_peak(const float* x, float* out, int tiles, int k_half, void* stream) {
  const int blocks = (tiles * kTileElems / kPerThread + kFmaThreads - 1) / kFmaThreads;
  fma_peak_kernel<<<blocks, kFmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, tiles,
                                                                                 k_half);
  return static_cast<int>(cudaGetLastError());
}
