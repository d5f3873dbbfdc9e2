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
// of magnitude: by instruction issue in the scan.  The simple design
// follows from that:
//   * one thread per pixel (per frame); no tiles and no data movement
//     beyond the output write;
//   * the scan reads compact sphere rows (cx, cy, cz, r * r), 16 bytes a
//     row (<= 640 rows: 10 KB), and the plane and box tables, all copied
//     into shared memory once per block; the sphere payload (albedo,
//     reflectivity, roughness, class), which a bounce reads once for its
//     winner, stays in device memory.  Every thread scans the same
//     primitive index at the same time, so each shared-memory read is a
//     warp-wide broadcast.  The TPU kernel baked the tables in as
//     compile-time constants and recompiled per scene; this kernel is
//     built once and takes any scene;
//   * the sphere scan is trace.cuh's rejecting scan: per row the terms up
//     to disc, and the square root, roots and tie rules only where disc
//     >= 0, behind one branch per group of rows that a warp skips when
//     none of its lanes needs it;
//   * a ray that dies leaves the loop (`break`).  The TPU kernel instead
//     skipped a bounce only when a whole tile was dead (>= 64 primitives);
//     both are exact, because a dead ray changes no carried value.
//
// The per-pixel code, its bit-level contract with the JAX package (and
// with render_tile_plain) and its tie rules are in trace.cuh, which the
// blockwise kernel shares.
//
// render_record_kernel replaces the same TPU kernel with record=True
// (pallas_render.py:686, _compiled_record): one sample per pixel, and per
// bounce the replay record that rt_tpu_torch.replay consumes (trace.cuh's
// record_pixel, the record form of bounce_once with the unrolled kernel's
// conventions).  Same tables in shared memory, same one thread per pixel.
// What bounds it on this card: the record writes, 7 x 4 bytes per pixel per
// bounce (107 MB at 800x600, depth 8), coalesced across a warp (one array
// row per bounce); the trace itself is the render kernel's 1-spp frame.
// Unlike the render kernel it cannot `break` out of a dead path: every
// bounce writes its draws, as the JAX kernel does.  The JAX kernel bakes
// its tables and knows at compile time whether they hold a dielectric
// (it computes the reflect bit only then); here the block finds out while
// it copies the tables (__syncthreads_or).  It copies the full 10- and
// 12-float rows into shared memory and scans them with the table-row scan
// (kGeoTable), not the rejecting scan.

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
  // compact sphere rows, then the plane and box rows
  extern __shared__ float4 s_geo[];
  float* s_pl = reinterpret_cast<float*>(s_geo + n_spheres);
  float* s_bx = s_pl + n_planes * kPrimCols;
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
    const float* q = spheres + i * kPrimCols;
    s_geo[i] = make_float4(q[0], q[1], q[2], q[3] * q[3]);
  }
  for (int i = threadIdx.x; i < n_planes * kPrimCols; i += blockDim.x) s_pl[i] = planes[i];
  for (int i = threadIdx.x; i < n_boxes * kBoxCols; i += blockDim.x) s_bx[i] = boxes[i];
  __syncthreads();

  const int n = width * height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n * frames) return;
  const int frame = gid / n;
  const int idx = gid - frame * n;  // flat pixel index within the frame
  const Tables T{spheres, n_spheres, s_pl, n_planes, s_bx, n_boxes};
  float acc[3];
  trace_pixel<kPrimCols, kBoxCols, kGeoCompact>(
      T, s_geo, cam, static_cast<uint32_t>(idx), static_cast<float>(idx % width),
      static_cast<float>(idx / width), static_cast<uint32_t>(seeds[frame]), inv_w, inv_h, spp,
      max_bounces, center_sample, rng_sphere, acc);

  float* o = out + static_cast<int64_t>(gid) * 3;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
}

__global__ void __launch_bounds__(kThreads) render_record_kernel(
    const float* __restrict__ spheres, int n_spheres,
    const float* __restrict__ planes, int n_planes,
    const float* __restrict__ boxes, int n_boxes,
    const float* __restrict__ cam, const int32_t* __restrict__ seeds, RecordPtrs P, int width,
    int height, float inv_w, float inv_h, int max_bounces, int center_sample, int rng_sphere) {
  extern __shared__ float smem[];
  float* s_pl = smem;
  float* s_sp = s_pl + n_planes * kPrimCols;
  float* s_bx = s_sp + n_spheres * kPrimCols;
  for (int i = threadIdx.x; i < n_planes * kPrimCols; i += blockDim.x) s_pl[i] = planes[i];
  for (int i = threadIdx.x; i < n_spheres * kPrimCols; i += blockDim.x) s_sp[i] = spheres[i];
  for (int i = threadIdx.x; i < n_boxes * kBoxCols; i += blockDim.x) s_bx[i] = boxes[i];
  // whether any table row's class (column 9, boxes 11) is dielectric
  int die = 0;
  for (int i = threadIdx.x; i < n_planes; i += blockDim.x) die |= planes[i * kPrimCols + 9] == 2.0f;
  for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
    die |= spheres[i * kPrimCols + 9] == 2.0f;
  }
  for (int i = threadIdx.x; i < n_boxes; i += blockDim.x) die |= boxes[i * kBoxCols + 11] == 2.0f;
  const bool has_die = __syncthreads_or(die) != 0;

  const int n = width * height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const Tables T{s_sp, n_spheres, s_pl, n_planes, s_bx, n_boxes};
  record_pixel<kPrimCols, kBoxCols, kRecUnrolled>(
      T, cam, static_cast<uint32_t>(gid), n, static_cast<float>(gid % width),
      static_cast<float>(gid / width), static_cast<uint32_t>(seeds[0]), inv_w, inv_h,
      max_bounces, center_sample, rng_sphere, has_die, P);
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
  const size_t smem = sizeof(float4) * static_cast<size_t>(n_spheres) +
                      sizeof(float) * (static_cast<size_t>(n_planes) * kPrimCols +
                                       static_cast<size_t>(n_boxes) * kBoxCols);
  render_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, out,
      width, height, frames, inv_w, inv_h, spp, max_bounces, center_sample,
      rng_sphere);
  return static_cast<int>(cudaGetLastError());
}

// Launches one record call on `stream`; returns cudaGetLastError() as an
// int.  Tables as rt_render_forward; seeds: (1,) int32; rad: (height,
// width, 3) float32; kind, idx, bits: (max_bounces, N) int32; urx, ury,
// urz, coin: (max_bounces, N) float32; jitter: (2, N) float32 (N = width *
// height).
extern "C" int rt_render_record(
    const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* boxes, int n_boxes, const float* cam, const int32_t* seeds, float* rad,
    int32_t* kind, int32_t* idx, int32_t* bits, float* urx, float* ury, float* urz,
    float* coin, float* jitter, int width, int height, float inv_w, float inv_h,
    int max_bounces, int center_sample, int rng_sphere, void* stream) {
  const int blocks = (width * height + kThreads - 1) / kThreads;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_spheres + n_planes) * kPrimCols +
                       static_cast<size_t>(n_boxes) * kBoxCols);
  const RecordPtrs P{rad, kind, idx, bits, urx, ury, urz, coin, jitter};
  render_record_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, P, width, height,
      inv_w, inv_h, max_bounces, center_sample, rng_sphere);
  return static_cast<int>(cudaGetLastError());
}
