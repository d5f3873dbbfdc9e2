// Fused forward+backward gradient kernel with runtime primitive tables of
// any size up to 16384 rows, for Hopper (sm_90a).
//
// What it computes: the reverse of one sample along the forward launch's
// recorded path.  The blockwise training step (rt_tpu_torch/ops/
// blockwise_grad.py) first runs the words form of the blockwise forward
// kernel for each sample (blockwise_kernel.cu): its frame, and per bounce
// the winner word of every pixel (row, plane bit 24, miss bit 25).  This
// kernel then replays that sample's path: per live bounce it takes the
// winner from its word and recomputes the hit with the scan's own
// expressions on that one row (bounce.cuh replay_winner; no scan), takes
// the decision bits and the _bounce_forward advance, stashes the bounce,
// and then runs the reverse sweep through the hand-written adjoint of
// pallas_grad's _bounce_smooth fed the caller's pixel cotangent, the
// per-row table gradients and the camera cotangent.  Together with the
// forward launch it computes what the TPU kernel
// rt_tpu/ops/pallas_blockwise_grad.py::_make_bw_grad_kernel (rng_impl=
// "hash") computes, which scans every row again in its own forward sweep:
// the replayed winner is bit for bit the scan's whenever the gradient
// sweep's ray is the forward kernel's.  The two sweeps differ in one clamp
// only: the render dielectric takes cos_t = sqrt(max(1 - sin2, 0)), the
// gradient's sqrt(max(1 - sin2, 1e-12)), so they part only on a refraction
// with sin2 == 1.0f exactly (in float32, 1 - sin2 is 0 or at least
// 5.96e-8); tests/test_torch_blockwise_grad.py and chip_smoke.py count such
// rays (none on their inputs).  The per-ray code is the per-sample
// gradient kernel's (bounce.cuh, whose scan form rows 3 and 4 keep): the
// two TPU kernels compute one function, and differ in where their tables
// and gradient accumulators live.
//
// Outputs, float64, are ADDED to: sg (9, n_spheres) -- centre x/y/z,
// radius, albedo r/g/b, reflectivity, roughness of each sphere,
// slot-major; pg (5, n_planes) -- the plane material slots (the gradient
// pytree reads no plane geometry); cg (16) -- the 15 camera floats and
// padding.  The caller zeroes them once per training step and passes the
// same tensors to every sample's launch, so a step sums its samples with
// no reduction between launches.
//
// What bounds it on this card.  FP32 issue: per live bounce one winner
// test (~20-30 operations), ~100 for the rest of the forward bounce and
// ~200-350 for its adjoint; before the words form the scan of every row
// (500 spheres: ~15 K operations per live bounce) was two thirds of the
// forward launch's work over again.  Device-memory traffic per live
// bounce: its winner word read (4 bytes), the stash written and read back
// (40 bytes each way), the winner's row (from L1/L2); per pixel the
// cotangent (12 bytes).  And the sums: without the scan, ablation builds
// (chip_ab.py; PERF.md) put 86% of the kernel at 1920x1080 in its
// per-row float64 atomics, nine per hit, most of them on the ground
// sphere's nine addresses (2 M rays per launch), and 7% in the camera's
// block reductions.
// The design:
//   * one thread per pixel; tables read from device memory (a 16384-row
//     table does not fit in shared memory); each lane reads its own
//     winner's row;
//   * a dead ray leaves its forward loop (`break`); words past a path's
//     end are never read;
//   * the stash is the per-sample kernel's: a pixel-minor scratch tensor of
//     origin, direction and throughput (9 floats) and one packed word
//     (decision bits, the winner's row in bits 16..31) per bounce, plus the
//     live-bounce count; the payload is re-read from the winner's row and
//     the random numbers are recomputed from the counter hash;
//   * the reverse sweep is warp-uniform, as in grad_kernel.cu: every lane
//     runs the warp's longest path, a lane past its own live bounces (or
//     past the frame) with word 0, which bounce_adjoint passes through as
//     the exact identity and which adds no gradient;
//   * so the per-row gradients are summed per warp by winner first
//     (bounce.cuh warp_add_prim_grad: lanes grouped with
//     __match_any_sync, each group's 9 floats summed by a butterfly of
//     shuffles), and the groups' leaders add to the global (9, S) and (5,
//     P) tables with float64 atomicAdd: 9 * 16384 floats do not fit in
//     shared memory, and per-block partials of that table would take
//     gigabytes at 1080p.  The tables are float64: the order of the
//     atomics varies from run to run, and in float32 a row hit by most of
//     57,600 rays (the ground sphere at 320x180) then summed to within
//     4.7e-6 of its L1 only, half the tolerance chip_smoke.py holds it to
//     (measured on an H100); sm_90 adds float64 in L2 natively;
//   * the camera sums go over the warp by shuffles, then over the block's
//     4 warps in a fixed order, and one float64 atomicAdd per block and
//     float.

#include "bounce.cuh"

namespace {

constexpr int kCols = 16;

struct Args {
  const float* spheres; int n_spheres;
  const float* planes; int n_planes;
  const float* cam; const int32_t* seeds;
  const float* cot;     // (n, 3) pixel cotangent
  const int32_t* words; // (max_bounces, n) the forward launch's winner words
  double* sg;           // (9, n_spheres), added to
  double* pg;           // (5, n_planes), added to
  double* cg;           // (16,), added to
  Stash stash;
  int width, height, center0, rng_sphere;
  float inv_w, inv_h;
};

// At least 4 blocks per SM (at most 128 registers): left free, ptxas
// spilled the earlier scan form of this kernel, 1% slower (chip_ab.py);
// the scan-free form takes 96 registers either way.
__global__ void __launch_bounds__(kThreads, 4) bw_grad_kernel(Args A) {
  __shared__ float red[kThreads / 32 * kCam];
  const int n = A.width * A.height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  float cam_acc[kCam];
  for (int i = 0; i < kCam; ++i) cam_acc[i] = 0.0f;

  // no early return: every lane of a warp reaches the warp sums below
  const bool in_frame = gid < n;
  const Cam cam = load_cam(A.cam);
  const float px = static_cast<float>(gid % A.width);
  const float py = static_cast<float>(gid / A.width);
  const uint32_t pix = static_cast<uint32_t>(gid);
  const uint32_t seed = static_cast<uint32_t>(A.seeds[0]);
  float jx = hash_u01(pix, seed, 1u), jy = hash_u01(pix, seed, 2u);
  if (A.center0) { jx = 0.5f; jy = 0.5f; }
  const RayParts rp = raygen_parts(cam, px, py, jx, jy, A.inv_w, A.inv_h);
  float crad[3] = {0.0f, 0.0f, 0.0f};
  if (in_frame) {
    // ---- forward sweep along the recorded winners (its radiance is not
    // needed: the caller's frame and loss come from the forward kernel) ----
    float img[3] = {0.0f, 0.0f, 0.0f};
    forward_sample<kCols, true>(A.planes, A.n_planes, A.spheres, A.n_spheres, cam, rp, pix, seed,
                                0, gid, A.rng_sphere, A.stash, img, A.words);
    for (int c = 0; c < 3; ++c) crad[c] = A.cot[gid * 3 + c];
  }

  // ---- reverse sweep, warp-uniform: every lane runs the warp's longest
  // path, a lane past its own live bounces (or past the frame) with word 0
  // (the identity, no gradient), so that all 32 lanes reach the per-row
  // sums together ----
  float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, ct[3] = {0.0f, 0.0f, 0.0f};
  const int nb = in_frame ? A.stash.nb[gid] : 0;
  for (int b = __reduce_max_sync(kFull, nb) - 1; b >= 0; --b) {
    float v[kStashF];
    uint32_t word = 0u;
    float ux = 0.0f, uy = 0.0f, uz = 0.0f;
    for (int k = 0; k < kStashF; ++k) v[k] = 0.0f;
    if (b < nb) {
      for (int k = 0; k < kStashF; ++k) v[k] = A.stash.f[A.stash.fi(0, b, k, gid)];
      word = static_cast<uint32_t>(A.stash.word[A.stash.wi(0, b, gid)]);
      unit_draws(pix, seed, b, A.rng_sphere, ux, uy, uz);
    }
    const PrimGrad g = bounce_adjoint<kCols>(A.planes, A.spheres, v, word, ux, uy, uz, crad, co,
                                             cd, ct);
    warp_add_prim_grad<true>(g, A.sg, A.pg, A.n_spheres, A.n_planes);
  }
  if (in_frame) raygen_adjoint(cam, rp, co, cd, cam_acc);

  // the camera partials: over the warp by shuffles, then over the block's
  // warps in a fixed order, and one float64 atomic per block and float
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < kCam; ++i) {
    const float c = warp_sum(cam_acc[i]);
    if (lane == 0) red[warp * kCam + i] = c;
  }
  __syncthreads();
  if (threadIdx.x < kCam) {
    float t = red[threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) t = t + red[w * kCam + threadIdx.x];
    atomicAdd(A.cg + threadIdx.x, static_cast<double>(t));
  }
}

}  // namespace

// ---- host entry point ----
// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32 (rows, 16), of which the first n_* rows are
// used; seeds (1,) int32; cot (height*width, 3); words (max_bounces,
// height*width) int32, the sample's forward launch's winner words
// (rt_blockwise_forward_words); the stash buffers hold max_bounces*9*n
// floats, max_bounces*n and n int32.  sg (9, n_spheres), pg (5, n_planes)
// and cg (16,), float64, are added to.
extern "C" int rt_bw_grad(
    const float* spheres, int n_spheres, const float* planes, int n_planes, const float* cam,
    const int32_t* seeds, const float* cot, const int32_t* words, double* sg, double* pg,
    double* cg, float* stash_f,
    int32_t* stash_word, int32_t* stash_nb, int width, int height, int max_bounces,
    int center0, int rng_sphere, float inv_w, float inv_h, void* stream) {
  Args a;
  a.spheres = spheres; a.n_spheres = n_spheres;
  a.planes = planes; a.n_planes = n_planes;
  a.cam = cam; a.seeds = seeds; a.cot = cot; a.words = words;
  a.sg = sg; a.pg = pg; a.cg = cg;
  a.stash.f = stash_f; a.stash.word = stash_word; a.stash.nb = stash_nb;
  a.stash.n = width * height; a.stash.max_bounces = max_bounces;
  a.width = width; a.height = height; a.center0 = center0; a.rng_sphere = rng_sphere;
  a.inv_w = inv_w; a.inv_h = inv_h;
  const int blocks = (width * height + kThreads - 1) / kThreads;
  bw_grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
