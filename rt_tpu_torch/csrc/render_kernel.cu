// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the TPU kernel rt_tpu/ops/pallas_render.py::_make_kernel
// (record=False, rng_impl="hash"): raygen -> bounce loop (closest hit over
// planes, spheres and optional boxes -> sky on miss -> lambert / metal /
// dielectric scatter) -> sum of pre-gamma radiance over `spp` samples.
// The caller (rt_tpu_torch/ops/render.py) chains calls of up to 4 samples
// and takes the mean and gamma, exactly as the JAX package does.
//
// What bounds it on this card: FP32 ALU issue.  A ray costs about 3 KFLOP
// when all 8 bounces of the 3-sphere scene run (the TPU kernel's dense
// count), and the closest-hit scan adds ~20 FLOP per primitive per bounce
// (500 spheres: ~10 KFLOP per bounce).  With the per-ray `break` below, a
// ray pays only for the bounces it lives, and most rays reach the sky long
// before the 8th bounce.  The only
// device-memory traffic is the tables (read once per block, from L2) and
// one float3 written per pixel, so the kernel is compute bound by orders
// of magnitude.  The simple design follows from that:
//   * one thread per pixel (per frame); no tiles and no data movement
//     beyond the output write;
//   * the primitive tables (<= 640 rows, 25.6 KB for spheres and planes,
//     30.7 KB with boxes) are copied into shared memory once per block.
//     Every thread scans the same primitive index at the same time, so
//     each shared-memory read is a warp-wide broadcast.  The TPU kernel
//     baked the tables in as compile-time constants and recompiled per
//     scene; this kernel is built once and takes any scene;
//   * a ray that dies leaves the loop (`break`).  The TPU kernel instead
//     skipped a bounce only when a whole tile was dead (>= 64 primitives);
//     both are exact, because a dead ray changes no carried value.
//
// The per-pixel code, its bit-level contract with the JAX package (and
// with render_tile_plain) and its tie rules are in trace.cuh, which the
// blockwise kernel shares.

#include "trace.cuh"

namespace {

constexpr int kPrimCols = 10;  // [cx|nx, cy|ny, cz|nz, r|d, alb r g b, refl, rough, cls]
constexpr int kBoxCols = 12;   // [cx, cy, cz, ex, ey, ez, alb r g b, refl, rough, cls]

__global__ void __launch_bounds__(kThreads) render_kernel(
    const float* __restrict__ spheres, int n_spheres,
    const float* __restrict__ planes, int n_planes,
    const float* __restrict__ boxes, int n_boxes,
    const float* __restrict__ cam, const int32_t* __restrict__ seeds,
    float* __restrict__ out, int width, int height, int frames,
    float inv_w, float inv_h, int spp, int max_bounces, int center_sample,
    int rng_sphere) {
  extern __shared__ float smem[];
  float* s_pl = smem;
  float* s_sp = s_pl + n_planes * kPrimCols;
  float* s_bx = s_sp + n_spheres * kPrimCols;
  for (int i = threadIdx.x; i < n_planes * kPrimCols; i += blockDim.x) s_pl[i] = planes[i];
  for (int i = threadIdx.x; i < n_spheres * kPrimCols; i += blockDim.x) s_sp[i] = spheres[i];
  for (int i = threadIdx.x; i < n_boxes * kBoxCols; i += blockDim.x) s_bx[i] = boxes[i];
  __syncthreads();

  const int n = width * height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n * frames) return;
  const int frame = gid / n;
  const int idx = gid - frame * n;  // flat pixel index within the frame
  const Tables T{s_sp, n_spheres, s_pl, n_planes, s_bx, n_boxes};
  float acc[3];
  trace_pixel<kPrimCols, kBoxCols>(
      T, cam, static_cast<uint32_t>(idx), static_cast<float>(idx % width),
      static_cast<float>(idx / width), static_cast<uint32_t>(seeds[frame]), inv_w, inv_h, spp,
      max_bounces, center_sample, rng_sphere, acc);

  float* o = out + static_cast<int64_t>(gid) * 3;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
}

}  // namespace

// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32: spheres/planes (n, 10), boxes (n, 12).
// out: (frames, height, width, 3) float32; seeds: (frames,) int32.
extern "C" int rt_render_forward(
    const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* boxes, int n_boxes, const float* cam, const int32_t* seeds,
    float* out, int width, int height, int frames, float inv_w, float inv_h,
    int spp, int max_bounces, int center_sample, int rng_sphere, void* stream) {
  const int total = width * height * frames;
  const int blocks = (total + kThreads - 1) / kThreads;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_spheres + n_planes) * kPrimCols +
                       static_cast<size_t>(n_boxes) * kBoxCols);
  render_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, out,
      width, height, frames, inv_w, inv_h, spp, max_bounces, center_sample,
      rng_sphere);
  return static_cast<int>(cudaGetLastError());
}
