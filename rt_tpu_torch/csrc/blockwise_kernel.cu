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
// What bounds it on this card: instruction issue in the closest-hit scan
// (one FP32 or other instruction per scheduler per clock).  Every (live
// ray, sphere row) pair needs ~17 operations up to the `disc >= 0` test;
// only the pairs that pass it need the square root, the roots and the tie
// rules (~12 more).  Device-memory traffic is the tables and one float3
// written per pixel.
//
// The scan is trace.cuh's rejecting scan (scan_spheres_rejecting): each
// row is one 128-bit load and the terms up to disc; the root work runs
// behind one branch per group of kRejectGroup rows, which a warp skips
// when none of its lanes has a row with disc >= 0 (the rows' loads of a
// group are issued together).  Where its rows live.
// The TPU kernel keeps the tables in VMEM and streams them through the
// scan in blocks of 8-128 rows.  Here a table may have 16384 rows of 16
// floats (1 MB), more than a block's 227 KB of shared memory.  The scan
// reads only (cx, cy, cz, r), so each block stages compact rows (cx, cy,
// cz, r * r), 16 bytes a row, in shared memory when the table has at most
// kStageRows spheres (32 KB: up to the 2048 padded rows past which
// auto_route takes the wavefront route); beyond that it reads each row's
// float4 head (cx, cy, cz, r) from device memory.  Every lane of a warp
// that is still scanning is at the same row at the same time (each live
// ray scans every row in index order), so each load is one warp-wide
// broadcast.  The staging is the only barrier, at the start: streaming
// the table through shared memory in chunks would need every thread of
// the block at every chunk's barrier, so a dead ray could not leave its
// loop, and the per-ray `break` that the forward kernels rely on (most
// rays die after a few bounces) is worth more.
//
// The words form (blockwise_kernel<true, *>, rt_blockwise_forward_words) is
// the launch of the blockwise training step: one sample, and per bounce
// each pixel's winner word (trace_pixel's words form), which the blockwise
// gradient kernel replays instead of scanning again (bw_grad_kernel.cu).
// The serving form (blockwise_kernel<false, *>) compiles without it.  The
// words add 4 bytes per pixel and bounce of writes (66 MB at 1920x1080 and
// depth 8), against the scan's ~15 K operations per live bounce.
//
// blockwise_record_kernel replaces pallas_blockwise.py::_make_bw_record_kernel
// (the record pass of pallas_loss_and_grad past the unrolled kernel's 640
// primitives; its record math is _bounce_once's want_record="replay"): one
// sample per pixel with the replay records, trace.cuh's record_pixel with
// the blockwise kernel's record conventions.  Its spheres are scanned as
// blockwise_kernel's: the rejecting scan over compact rows staged in shared
// memory up to kStageRows spheres, over the rows' heads in device memory
// beyond (a record scene may have 16384 primitives), the near-root flag of
// the winner kept by the row it takes (trace.cuh's record note); planes
// and boxes (24 boxes on the box scene, against 660 spheres) keep their
// table rows.
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
constexpr int kStageRows = 2048;  // the most sphere rows staged in shared memory (32 KB)

// Whether a launch on n_spheres sphere rows takes the staged form
// (kGeoCompact) or the device-memory form (kGeoHead16).
bool staged(int n_spheres) { return n_spheres <= kStageRows; }

// The sphere rows the rejecting scan reads: kGeoCompact stages the
// n_spheres compact rows (cx, cy, cz, r * r) in the block's dynamic shared
// memory `s_geo` (every thread of the block reaches the barrier),
// kGeoHead16 reads the rows' float4 heads from device memory.
template <int kGeo>
__device__ __forceinline__ const float4* scan_rows(const float* __restrict__ spheres,
                                                   int n_spheres, float4* s_geo) {
  if constexpr (kGeo == kGeoCompact) {
    for (int i = threadIdx.x; i < n_spheres; i += blockDim.x) {
      const float* q = spheres + i * kCols;
      s_geo[i] = make_float4(q[0], q[1], q[2], q[3] * q[3]);
    }
    __syncthreads();
    return s_geo;
  }
  return reinterpret_cast<const float4*>(spheres);
}

// kWords: the words form (trace_pixel's), one sample per launch.  kGeo:
// kGeoCompact stages the n_spheres compact rows in dynamic shared memory
// (n_spheres <= kStageRows), kGeoHead16 reads the rows' heads from device
// memory.
template <bool kWords, int kGeo>
__global__ void __launch_bounds__(kThreads) blockwise_kernel(
    const float* __restrict__ spheres, int n_spheres,
    const float* __restrict__ planes, int n_planes,
    const float* __restrict__ boxes, int n_boxes,
    const float* __restrict__ cam, const int32_t* __restrict__ seeds,
    float* __restrict__ out, int width, int height, float inv_w, float inv_h, int spp,
    int max_bounces, int center_sample, int rng_sphere, int32_t* __restrict__ words) {
  extern __shared__ float4 s_geo[];
  const float4* geo = scan_rows<kGeo>(spheres, n_spheres, s_geo);
  const int n = width * height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const Tables T{spheres, n_spheres, planes, n_planes, boxes, n_boxes};
  float acc[3];
  trace_pixel<kCols, kCols, kGeo, kWords>(
      T, geo, cam, static_cast<uint32_t>(gid), static_cast<float>(gid % width),
      static_cast<float>(gid / width), static_cast<uint32_t>(seeds[0]), inv_w, inv_h, spp,
      max_bounces, center_sample, rng_sphere, acc, words, n);
  float* o = out + static_cast<int64_t>(gid) * 3;
  o[0] = acc[0];
  o[1] = acc[1];
  o[2] = acc[2];
}

// kGeo as blockwise_kernel's.
template <int kGeo>
__global__ void __launch_bounds__(kThreads) blockwise_record_kernel(
    const float* __restrict__ spheres, int n_spheres,
    const float* __restrict__ planes, int n_planes,
    const float* __restrict__ boxes, int n_boxes,
    const float* __restrict__ cam, const int32_t* __restrict__ seeds, RecordPtrs P, int width,
    int height, float inv_w, float inv_h, int max_bounces, int center_sample, int rng_sphere) {
  extern __shared__ float4 s_geo[];
  const float4* geo = scan_rows<kGeo>(spheres, n_spheres, s_geo);
  const int n = width * height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const Tables T{spheres, n_spheres, planes, n_planes, boxes, n_boxes};
  record_pixel<kCols, kCols, kRecBlockwise, kGeo>(
      T, cam, static_cast<uint32_t>(gid), n, static_cast<float>(gid % width),
      static_cast<float>(gid / width), static_cast<uint32_t>(seeds[0]), inv_w, inv_h,
      max_bounces, center_sample, rng_sphere, true, P, geo);
}

// One launch of blockwise_kernel<kWords, *>: the staged form where the
// sphere rows fit kStageRows, else the device-memory form.
template <bool kWords>
void launch_blockwise(const float* spheres, int n_spheres, const float* planes, int n_planes,
                      const float* boxes, int n_boxes, const float* cam, const int32_t* seeds,
                      float* out, int width, int height, float inv_w, float inv_h, int spp,
                      int max_bounces, int center_sample, int rng_sphere, int32_t* words,
                      cudaStream_t stream) {
  const int blocks = (width * height + kThreads - 1) / kThreads;
  if (staged(n_spheres)) {
    const size_t smem = sizeof(float4) * static_cast<size_t>(n_spheres);
    blockwise_kernel<kWords, kGeoCompact><<<blocks, kThreads, smem, stream>>>(
        spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, out, width, height,
        inv_w, inv_h, spp, max_bounces, center_sample, rng_sphere, words);
  } else {
    blockwise_kernel<kWords, kGeoHead16><<<blocks, kThreads, 0, stream>>>(
        spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, out, width, height,
        inv_w, inv_h, spp, max_bounces, center_sample, rng_sphere, words);
  }
}

}  // namespace

// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32 (rows, 16), of which the first n_* rows are
// used, the spheres' 16-byte aligned; seeds: (1,) int32; out: (height,
// width, 3) float32.
extern "C" int rt_blockwise_forward(
    const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* boxes, int n_boxes, const float* cam, const int32_t* seeds, float* out,
    int width, int height, float inv_w, float inv_h, int spp, int max_bounces,
    int center_sample, int rng_sphere, void* stream) {
  launch_blockwise<false>(spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, out,
                          width, height, inv_w, inv_h, spp, max_bounces, center_sample,
                          rng_sphere, nullptr, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Launches one call of the words form on `stream` (one sample); returns
// cudaGetLastError() as an int.  Arguments as rt_blockwise_forward with
// spp = 1, and words: (max_bounces, height*width) int32, every entry
// written (trace_pixel's words form).
extern "C" int rt_blockwise_forward_words(
    const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* boxes, int n_boxes, const float* cam, const int32_t* seeds, float* out,
    int32_t* words, int width, int height, float inv_w, float inv_h, int max_bounces,
    int center_sample, int rng_sphere, void* stream) {
  launch_blockwise<true>(spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, out,
                         width, height, inv_w, inv_h, 1, max_bounces, center_sample, rng_sphere,
                         words, static_cast<cudaStream_t>(stream));
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged(n_spheres)) {
    const size_t smem = sizeof(float4) * static_cast<size_t>(n_spheres);
    blockwise_record_kernel<kGeoCompact><<<blocks, kThreads, smem, s>>>(
        spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, P, width, height,
        inv_w, inv_h, max_bounces, center_sample, rng_sphere);
  } else {
    blockwise_record_kernel<kGeoHead16><<<blocks, kThreads, 0, s>>>(
        spheres, n_spheres, planes, n_planes, boxes, n_boxes, cam, seeds, P, width, height,
        inv_w, inv_h, max_bounces, center_sample, rng_sphere);
  }
  return static_cast<int>(cudaGetLastError());
}
