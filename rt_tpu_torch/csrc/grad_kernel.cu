// Fused forward+backward MSE gradient kernels for Hopper (sm_90a).
//
// Replaces two TPU kernels of rt_tpu/ops/pallas_grad.py, which share all
// their device math:
//   * mse_step_kernel: _make_mono_kernel (record/cot_input=False,
//     residuals="recompute") -- a whole MSE training step in one launch:
//     every sample's forward sweep with a stash, the loss and the pixel
//     cotangent against the target, then every sample's reverse sweep;
//   * grad_kernel: _make_grad_kernel -- one sample's forward sweep with a
//     stash, then the reverse sweep fed a pixel cotangent from the caller
//     (the per-sample pipeline of make_mse_step(mode="multi")).
// Both write, per block, the partial sums of the per-primitive gradients
// (9 slots per sphere: centre x/y/z, radius, albedo r/g/b, reflectivity,
// roughness; the 5 material slots per plane -- the gradient pytree reads
// no plane geometry, so the normal and offset slots are left out) and of
// the 15 camera floats (16 with padding), and mse_step_kernel the loss.
// The caller (rt_tpu_torch/ops/grad.py) sums the partials with torch.sum.
//
// What bounds it on this card.  Its FP32 operations (chip_smoke.py counts
// them: a closest-hit scan of 20-30 per primitive and 50-120 more per live
// forward bounce; the reverse recomputes the bounce's primal from the
// stash and runs the hand-written adjoint, 200-350 per live bounce) and
// its stash traffic (40 bytes written and 40 read back per live (sample,
// bounce) of a pixel, ~250 MB per headline step) would each take under
// 0.1 ms per headline step (basic.toml 800x600, 4 spp, depth 8) at an
// H100's peak rates; the kernel takes ~0.9 ms there.  What may hold it
// above both: IEEE division and square root are instruction sequences
// (each counts as one operation above), ~125 registers per thread leave
// 16 warps per SM to hide latency, a lane whose ray died waits for the
// rest of its warp, and every hit adds 9 shared-memory atomics, mostly to
// the same primitive's slots across the warp.  Which of these dominates
// is not measured yet (PERF.md).  The design is the simple one, and
// follows the render kernel's:
//   * one thread per pixel; all samples of the pixel in that thread;
//   * the primitive tables (<= 640 rows) in shared memory, read as
//     warp-wide broadcasts, and a dead ray leaves its bounce loop
//     (`break`); the reverse starts at the last bounce the ray lived
//     through.  Both are exact: a dead bounce is the identity on the
//     carried values and their cotangents and adds no gradient;
//   * the stash lives in a scratch tensor the wrapper allocates, laid out
//     pixel-minor ([sample][bounce][field][pixel]) so that a warp's 32
//     threads touch 128 contiguous bytes: origin, direction, throughput
//     (9 floats) and one packed word (decision bits 0..11, winner index in
//     bits 16..31) per (sample, bounce), plus each sample's live-bounce
//     count;
//   * the random numbers are recomputed from the counter hash in the
//     reverse sweep instead of stashed;
//   * per-primitive gradients go to shared-memory accumulators with
//     atomicAdd (their order of summation varies from run to run; the
//     card check in chip_smoke.py prints the spread), and the loss and
//     camera sums go through a fixed-order tree reduction of the block.
//
// The per-ray code and its bit-level contract with the plain versions
// are in bounce.cuh, which the blockwise gradient kernel shares.

#include "bounce.cuh"

namespace {

constexpr int kCols = 10;  // [cx|nx, cy|ny, cz|nz, r|d, alb r g b, refl, rough, cls]

struct Args {
  const float* spheres; int n_spheres;
  const float* planes; int n_planes;
  const float* cam; const int32_t* seeds;
  const float* pix_in;  // mono: target (n, 3); per-sample: pixel cotangent (n, 3)
  float* loss_out;      // (blocks,), mono only
  float* sg_out;        // (blocks, 9, S)
  float* pg_out;        // (blocks, 5, P)
  float* cg_out;        // (blocks, 16)
  Stash stash;
  int width, height, spp, center0, rng_sphere;
  float inv_w, inv_h, inv_spp, cot_scale;
};

template <bool kMono>
__device__ __forceinline__ void fused_body(const Args& A) {
  extern __shared__ float smem[];
  float* s_pl = smem;
  float* s_sp = s_pl + A.n_planes * kCols;
  float* acc_s = s_sp + A.n_spheres * kCols;
  float* acc_p = acc_s + A.n_spheres * kSSlots;
  float* red = acc_p + A.n_planes * kPSlots;
  for (int i = threadIdx.x; i < A.n_planes * kCols; i += blockDim.x) s_pl[i] = A.planes[i];
  for (int i = threadIdx.x; i < A.n_spheres * kCols; i += blockDim.x) s_sp[i] = A.spheres[i];
  const int n_acc = A.n_spheres * kSSlots + A.n_planes * kPSlots;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc_s[i] = 0.0f;
  __syncthreads();

  const int n = A.width * A.height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  float loss = 0.0f;
  float cam_acc[kCam];
  for (int i = 0; i < kCam; ++i) cam_acc[i] = 0.0f;

  if (gid < n) {  // no early return: every thread reaches the barriers below
    const Cam cam = load_cam(A.cam);
    const float px = static_cast<float>(gid % A.width);
    const float py = static_cast<float>(gid / A.width);
    const uint32_t pix = static_cast<uint32_t>(gid);

    // ---- forward sweeps ----
    float img[3] = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < A.spp; ++s) {
      const uint32_t seed = static_cast<uint32_t>(A.seeds[s]);
      float jx = hash_u01(pix, seed, 1u), jy = hash_u01(pix, seed, 2u);
      if (s == 0 && A.center0) { jx = 0.5f; jy = 0.5f; }
      const RayParts rp = raygen_parts(cam, px, py, jx, jy, A.inv_w, A.inv_h);
      forward_sample<kCols>(s_pl, A.n_planes, s_sp, A.n_spheres, cam, rp, pix, seed, s, gid,
                            A.rng_sphere, A.stash, img);
    }

    // ---- pixel cotangent ----
    float crad[3];
    if (kMono) {
      float diff[3];
      for (int c = 0; c < 3; ++c) diff[c] = img[c] * A.inv_spp - A.pix_in[gid * 3 + c];
      loss = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
      for (int c = 0; c < 3; ++c) crad[c] = diff[c] * A.cot_scale;
    } else {
      for (int c = 0; c < 3; ++c) crad[c] = A.pix_in[gid * 3 + c];
    }

    // ---- reverse sweeps ----
    for (int s = 0; s < A.spp; ++s) {
      const uint32_t seed = static_cast<uint32_t>(A.seeds[s]);
      float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, ct[3] = {0.0f, 0.0f, 0.0f};
      const int nb = A.stash.nb[static_cast<size_t>(s) * n + gid];
      for (int b = nb - 1; b >= 0; --b) {
        float v[kStashF];
        for (int k = 0; k < kStashF; ++k) v[k] = A.stash.f[A.stash.fi(s, b, k, gid)];
        const uint32_t word = static_cast<uint32_t>(A.stash.word[A.stash.wi(s, b, gid)]);
        float ux, uy, uz;
        unit_draws(pix, seed, b, A.rng_sphere, ux, uy, uz);
        bounce_adjoint<kCols>(s_pl, s_sp, acc_s, acc_p, A.n_spheres, A.n_planes, v, word, ux,
                              uy, uz, crad, co, cd, ct);
      }
      float jx = hash_u01(pix, seed, 1u), jy = hash_u01(pix, seed, 2u);
      if (s == 0 && A.center0) { jx = 0.5f; jy = 0.5f; }
      const RayParts rp = raygen_parts(cam, px, py, jx, jy, A.inv_w, A.inv_h);
      raygen_adjoint(cam, rp, co, cd, cam_acc);
    }
  }

  // ---- block partials ----
  if (kMono) {
    const float l = block_sum(red, loss);
    if (threadIdx.x == 0) A.loss_out[blockIdx.x] = l;
  }
  for (int i = 0; i < kCam; ++i) {
    const float c = block_sum(red, cam_acc[i]);
    if (threadIdx.x == 0) A.cg_out[blockIdx.x * kCam + i] = c;
  }
  // block_sum ended with a barrier, so every atomicAdd has landed
  const int ns = A.n_spheres * kSSlots;
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    A.sg_out[static_cast<size_t>(blockIdx.x) * ns + i] = acc_s[i];
  const int np = A.n_planes * kPSlots;
  for (int i = threadIdx.x; i < np; i += blockDim.x)
    A.pg_out[static_cast<size_t>(blockIdx.x) * np + i] = acc_p[i];
}

__global__ void __launch_bounds__(kThreads) mse_step_kernel(Args a) { fused_body<true>(a); }
__global__ void __launch_bounds__(kThreads) grad_kernel(Args a) { fused_body<false>(a); }

}  // namespace

// ---- host entry point ----
// Launches one call on `stream`; returns cudaGetLastError() (or the error
// of raising the shared-memory limit) as an int.  mono != 0 runs
// mse_step_kernel (pix_in = target, all `spp` seeds, sample 0 at the pixel
// centre when center0), else grad_kernel (pix_in = pixel cotangent).
// Tables are row-major float32 (n, 10); pix_in (height*width, 3); the
// stash buffers hold spp*max_bounces*9*n floats, spp*max_bounces*n and
// spp*n int32.  Outputs: loss (blocks,), sg (blocks, 9, S), pg (blocks, 5,
// P), cg (blocks, 16) with blocks = ceil(width*height / 128).
extern "C" int rt_grad_fused(
    int mono, const float* spheres, int n_spheres, const float* planes, int n_planes,
    const float* cam, const int32_t* seeds, const float* pix_in, float* loss_out, float* sg_out,
    float* pg_out, float* cg_out, float* stash_f, int32_t* stash_word, int32_t* stash_nb,
    int width, int height, int spp, int max_bounces, int center0, int rng_sphere, float inv_w,
    float inv_h, float inv_spp, float cot_scale, void* stream) {
  Args a;
  a.spheres = spheres; a.n_spheres = n_spheres;
  a.planes = planes; a.n_planes = n_planes;
  a.cam = cam; a.seeds = seeds; a.pix_in = pix_in;
  a.loss_out = loss_out; a.sg_out = sg_out; a.pg_out = pg_out; a.cg_out = cg_out;
  a.stash.f = stash_f; a.stash.word = stash_word; a.stash.nb = stash_nb;
  a.stash.n = width * height; a.stash.max_bounces = max_bounces;
  a.width = width; a.height = height; a.spp = spp; a.center0 = center0;
  a.rng_sphere = rng_sphere; a.inv_w = inv_w; a.inv_h = inv_h;
  a.inv_spp = inv_spp; a.cot_scale = cot_scale;
  const int blocks = (width * height + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_spheres + n_planes) * kCols +
                                       static_cast<size_t>(n_spheres) * kSSlots +
                                       static_cast<size_t>(n_planes) * kPSlots + kThreads);
  const void* fn = mono ? reinterpret_cast<const void*>(mse_step_kernel)
                        : reinterpret_cast<const void*>(grad_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mono) {
    mse_step_kernel<<<blocks, kThreads, smem, st>>>(a);
  } else {
    grad_kernel<<<blocks, kThreads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
