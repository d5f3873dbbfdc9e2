// Forward path-tracing kernel with runtime primitive tables of any size up
// to 16384 rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel rt_tpu/ops/pallas_blockwise.py::
// _make_blockwise_kernel (scan="lean", rng_impl="hash"): raygen -> bounce
// loop (closest hit over the plane, sphere and, with --boxes, box tables
// -> sky on miss -> lambert / metal / dielectric scatter) -> sum of
// pre-gamma radiance over `spp` samples.  The caller
// (rt_tpu_torch/ops/blockwise.py) chains calls of up to 4 samples and takes
// the mean and gamma, as the JAX package does.  The per-pixel code is the
// render kernel's (trace.cuh): the two TPU kernels compute one function,
// and differ only in where their tables live.
//
// What bounds it on this card: FP32 issue in the closest-hit scan, ~20-30
// operations per primitive per live bounce (500 spheres: ~15 K operations
// per bounce, against ~100 for the rest of the bounce).  Device-memory
// traffic is the tables and one float3 written per pixel.
//
// Where the tables live.  The TPU kernel keeps them in VMEM and streams
// them through the scan in blocks of 8-128 rows.  Here a table may have
// 16384 rows of 16 floats (1 MB), more than a block's 227 KB of shared
// memory, so the render kernel's "copy the tables into shared memory once
// per block" does not carry over.  This kernel reads the rows from device
// memory instead.  Every lane of a warp that is still scanning is at the
// same row at the same time (each live ray scans every row in index
// order), so each load is one warp-wide broadcast, served from L1 (a
// 500-sphere table is 32 KB) or L2 (50 MB holds the largest table).  The
// other simple design, streaming the table through shared memory in
// chunks, needs every thread of the block at every chunk's barrier, so a
// dead ray could not leave its loop; the per-ray `break` that the forward
// kernels rely on (most rays die after a few bounces) is worth more.
// chip_smoke.py times this kernel against the render kernel on the same
// 500-sphere scene: the difference is the cost of the choice.
//
// blockwise_record_kernel replaces pallas_blockwise.py::_make_bw_record_kernel
// (the record pass of pallas_loss_and_grad past the unrolled kernel's 640
// primitives; its record math is _bounce_once's want_record="replay"): one
// sample per pixel with the replay records, trace.cuh's record_pixel with
// the blockwise kernel's record conventions, the tables read as above.
// The JAX kernel scans without cull or Morton order, so the recorded index
// (the table row) is the scene index.  What bounds it: the scan, as
// above, and the record writes (7 x 4 bytes per pixel per bounce).
//
// Rows: spheres and planes [cx|nx, cy|ny, cz|nz, r|d, alb r, g, b, refl,
// rough, cls, original index, 0...], boxes [cx, cy, cz, ex, ey, ez, alb r,
// g, b, refl, rough, cls, original index, 0...]; the index column is the
// JAX package's Morton-order tie-break and is not read here (the scan runs
// in index order).  Only the first n_* rows of each table are scanned.

#include "trace.cuh"

namespace {

constexpr int kCols = 16;

__global__ void __launch_bounds__(kThreads) blockwise_kernel(
    const float* __restrict__ spheres, int n_spheres,
    const float* __restrict__ planes, int n_planes,
    const float* __restrict__ boxes, int n_boxes,
    const float* __restrict__ cam, const int32_t* __restrict__ seeds,
    float* __restrict__ out, int width, int height, float inv_w, float inv_h, int spp,
    int max_bounces, int center_sample, int rng_sphere) {
  const int n = width * height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const Tables T{spheres, n_spheres, planes, n_planes, boxes, n_boxes};
  float acc[3];
  trace_pixel<kCols, kCols>(
      T, cam, static_cast<uint32_t>(gid), static_cast<float>(gid % width),
      static_cast<float>(gid / width), static_cast<uint32_t>(seeds[0]), inv_w, inv_h, spp,
      max_bounces, center_sample, rng_sphere, acc);
  float* o = out + static_cast<int64_t>(gid) * 3;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
}

__global__ void __launch_bounds__(kThreads) blockwise_record_kernel(
    const float* __restrict__ spheres, int n_spheres,
    const float* __restrict__ planes, int n_planes,
    const float* __restrict__ boxes, int n_boxes,
    const float* __restrict__ cam, const int32_t* __restrict__ seeds, RecordPtrs P, int width,
    int height, float inv_w, float inv_h, int max_bounces, int center_sample, int rng_sphere) {
  const int n = width * height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const Tables T{spheres, n_spheres, planes, n_planes, boxes, n_boxes};
  record_pixel<kCols, kCols, kRecBlockwise>(
      T, cam, static_cast<uint32_t>(gid), n, static_cast<float>(gid % width),
      static_cast<float>(gid / width), static_cast<uint32_t>(seeds[0]), inv_w, inv_h,
      max_bounces, center_sample, rng_sphere, true, P);
}

}  // namespace

// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32 (rows, 16), of which the first n_* rows are
// used; seeds: (1,) int32; out: (height, width, 3) float32.
extern "C" int rt_blockwise_forward(
    const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* boxes, int n_boxes, const float* cam, const int32_t* seeds, float* out,
    int width, int height, float inv_w, float inv_h, int spp, int max_bounces,
    int center_sample, int rng_sphere, void* stream) {
  const int blocks = (width * height + kThreads - 1) / kThreads;
  blockwise_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, out, width, height,
      inv_w, inv_h, spp, max_bounces, center_sample, rng_sphere);
  return static_cast<int>(cudaGetLastError());
}

// Launches one record call on `stream`; returns cudaGetLastError() as an
// int.  Tables as rt_blockwise_forward; outputs as rt_render_record
// (render_kernel.cu).
extern "C" int rt_blockwise_record(
    const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* boxes, int n_boxes, const float* cam, const int32_t* seeds, float* rad,
    int32_t* kind, int32_t* idx, int32_t* bits, float* urx, float* ury, float* urz,
    float* coin, float* jitter, int width, int height, float inv_w, float inv_h,
    int max_bounces, int center_sample, int rng_sphere, void* stream) {
  const int blocks = (width * height + kThreads - 1) / kThreads;
  const RecordPtrs P{rad, kind, idx, bits, urx, ury, urz, coin, jitter};
  blockwise_record_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, P, width, height,
      inv_w, inv_h, max_bounces, center_sample, rng_sphere);
  return static_cast<int>(cudaGetLastError());
}
