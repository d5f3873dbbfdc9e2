// Fused forward+backward gradient kernel with runtime primitive tables of
// any size up to 16384 rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel rt_tpu/ops/pallas_blockwise_grad.py::
// _make_bw_grad_kernel (rng_impl="hash"): one sample's forward sweep (the
// closest-hit scan over the plane and sphere tables, recording the winner's
// table row and near-root bit, the decision bits and the _bounce_forward
// advance), then the reverse sweep through the hand-written adjoint of
// pallas_grad's _bounce_smooth fed the caller's pixel cotangent, the
// per-row table gradients and the camera cotangent.  The per-ray code is
// the per-sample gradient kernel's (bounce.cuh): the two TPU kernels
// compute one function, and differ in where their tables and gradient
// accumulators live.
//
// Outputs, float64, are ADDED to: sg (9, n_spheres) -- centre x/y/z,
// radius, albedo r/g/b, reflectivity, roughness of each sphere,
// slot-major; pg (5, n_planes) -- the plane material slots (the gradient
// pytree reads no plane geometry); cg (16) -- the 15 camera floats and
// padding.  The caller (rt_tpu_torch/ops/blockwise_grad.py) zeroes them
// once per training step and passes the same tensors to every sample's
// launch, so a step sums its samples with no reduction between launches.
//
// What bounds it on this card.  FP32 issue: the scan costs ~20-30
// operations per primitive per live forward bounce (500 spheres: ~15 K per
// bounce), against ~100 for the rest of the forward bounce and ~200-350 for
// its adjoint.  Device-memory traffic: the stash, 40 bytes written and read
// back per live bounce of a pixel (663 MB allocated at 1920x1080, depth 8,
// of which only live bounces are touched), and the atomics below.
// The design is the simple one:
//   * one thread per pixel; tables read from device memory as warp-wide
//     broadcasts, for the reason blockwise_kernel.cu gives (a 16384-row
//     table does not fit in shared memory; every live lane scans the same
//     row at the same time);
//   * a dead ray leaves its forward loop (`break`) and the reverse starts
//     at the last bounce it lived through (exact: a dead bounce is the
//     identity on the carried values and their cotangents);
//   * the stash is the per-sample kernel's: a pixel-minor scratch tensor of
//     origin, direction and throughput (9 floats) and one packed word
//     (decision bits, the winner's row in bits 16..31) per bounce, plus the
//     live-bounce count; the payload is re-read from the winner's row and
//     the random numbers are recomputed from the counter hash;
//   * per-row gradients go straight to the global (9, S) and (5, P) tables
//     with atomicAdd (add_prim_grad, from the PrimGrad that bounce_adjoint
//     returns): 9 * 16384 floats do not fit in shared memory, and
//     per-block partials of that table would take gigabytes at 1080p.  The
//     tables are float64: the order of the atomics varies from run to run,
//     and in float32 a row hit by most of 57,600 rays (the ground sphere
//     at 320x180) then summed to within 4.7e-6 of its L1 only, half the
//     tolerance chip_smoke.py holds it to (measured on an H100); sm_90
//     adds float64 in L2 natively.
//     The camera sums go through a fixed-order tree reduction of the block
//     and one atomicAdd per block.

#include "bounce.cuh"

namespace {

constexpr int kCols = 16;

struct Args {
  const float* spheres; int n_spheres;
  const float* planes; int n_planes;
  const float* cam; const int32_t* seeds;
  const float* cot;     // (n, 3) pixel cotangent
  double* sg;           // (9, n_spheres), added to
  double* pg;           // (5, n_planes), added to
  double* cg;           // (16,), added to
  Stash stash;
  int width, height, center0, rng_sphere;
  float inv_w, inv_h;
};

// At least 4 blocks per SM (at most 128 registers): left free, ptxas picks
// 96 registers for this kernel and spills, 1% slower (chip_ab.py).
__global__ void __launch_bounds__(kThreads, 4) bw_grad_kernel(Args A) {
  __shared__ float red[kThreads];
  const int n = A.width * A.height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  float cam_acc[kCam];
  for (int i = 0; i < kCam; ++i) cam_acc[i] = 0.0f;

  if (gid < n) {  // no early return: every thread reaches the barriers below
    const Cam cam = load_cam(A.cam);
    const float px = static_cast<float>(gid % A.width);
    const float py = static_cast<float>(gid / A.width);
    const uint32_t pix = static_cast<uint32_t>(gid);
    const uint32_t seed = static_cast<uint32_t>(A.seeds[0]);
    float jx = hash_u01(pix, seed, 1u), jy = hash_u01(pix, seed, 2u);
    if (A.center0) { jx = 0.5f; jy = 0.5f; }
    const RayParts rp = raygen_parts(cam, px, py, jx, jy, A.inv_w, A.inv_h);

    // ---- forward sweep (its radiance is not needed: the caller's frame
    // and loss come from the forward kernel) ----
    float img[3] = {0.0f, 0.0f, 0.0f};
    forward_sample<kCols>(A.planes, A.n_planes, A.spheres, A.n_spheres, cam, rp, pix, seed, 0,
                          gid, A.rng_sphere, A.stash, img);

    // ---- reverse sweep ----
    float crad[3];
    for (int c = 0; c < 3; ++c) crad[c] = A.cot[gid * 3 + c];
    float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, ct[3] = {0.0f, 0.0f, 0.0f};
    const int nb = A.stash.nb[gid];
    for (int b = nb - 1; b >= 0; --b) {
      float v[kStashF];
      for (int k = 0; k < kStashF; ++k) v[k] = A.stash.f[A.stash.fi(0, b, k, gid)];
      const uint32_t word = static_cast<uint32_t>(A.stash.word[A.stash.wi(0, b, gid)]);
      float ux, uy, uz;
      unit_draws(pix, seed, b, A.rng_sphere, ux, uy, uz);
      add_prim_grad(bounce_adjoint<kCols>(A.planes, A.spheres, v, word, ux, uy, uz, crad, co,
                                          cd, ct),
                    A.sg, A.pg, A.n_spheres, A.n_planes);
    }
    raygen_adjoint(cam, rp, co, cd, cam_acc);
  }

  for (int i = 0; i < kCam; ++i) {
    const float c = block_sum(red, cam_acc[i]);
    if (threadIdx.x == 0) atomicAdd(A.cg + i, static_cast<double>(c));
  }
}

}  // namespace

// ---- host entry point ----
// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32 (rows, 16), of which the first n_* rows are
// used; seeds (1,) int32; cot (height*width, 3); the stash buffers hold
// max_bounces*9*n floats, max_bounces*n and n int32.  sg (9, n_spheres),
// pg (5, n_planes) and cg (16,), float64, are added to.
extern "C" int rt_bw_grad(
    const float* spheres, int n_spheres, const float* planes, int n_planes, const float* cam,
    const int32_t* seeds, const float* cot, double* sg, double* pg, double* cg, float* stash_f,
    int32_t* stash_word, int32_t* stash_nb, int width, int height, int max_bounces,
    int center0, int rng_sphere, float inv_w, float inv_h, void* stream) {
  Args a;
  a.spheres = spheres; a.n_spheres = n_spheres;
  a.planes = planes; a.n_planes = n_planes;
  a.cam = cam; a.seeds = seeds; a.cot = cot;
  a.sg = sg; a.pg = pg; a.cg = cg;
  a.stash.f = stash_f; a.stash.word = stash_word; a.stash.nb = stash_nb;
  a.stash.n = width * height; a.stash.max_bounces = max_bounces;
  a.width = width; a.height = height; a.center0 = center0; a.rng_sphere = rng_sphere;
  a.inv_w = inv_w; a.inv_h = inv_h;
  const int blocks = (width * height + kThreads - 1) / kThreads;
  bw_grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
