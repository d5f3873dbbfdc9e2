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
// H100's peak rates.  The first design took ~0.88 ms there, two thirds of
// it in the per-primitive sums: 9 shared-memory float atomicAdds per hit,
// each a compare-and-swap loop in the SASS (ATOMS.CAST.SPIN), with most
// lanes of a warp adding to the same sphere's slots (chip_ab.py's
// ablation split, PERF.md).  The design:
//   * one thread per pixel; all samples of the pixel in that thread;
//   * the primitive tables (<= 640 rows) in shared memory, read as
//     warp-wide broadcasts; a dead ray leaves its forward loop (`break`);
//   * the stash lives in a scratch tensor the wrapper allocates, laid out
//     pixel-minor ([sample][bounce][field][pixel]) so that a warp's 32
//     threads touch 128 contiguous bytes: origin, direction, throughput
//     (9 floats) and one packed word (decision bits 0..11, winner index in
//     bits 16..31) per (sample, bounce), plus each sample's live-bounce
//     count;
//   * the random numbers are recomputed from the counter hash in the
//     reverse sweep instead of stashed;
//   * the reverse sweep is warp-uniform: every lane runs the warp's
//     longest path, a lane past its own live bounces (or past the frame)
//     with word 0, which bounce_adjoint passes through as the exact
//     identity and which adds no gradient;
//   * so all 32 lanes reach the per-primitive sums together, and they are
//     summed per warp first (warp_add_prim_grad): lanes grouped by winner
//     with __match_any_sync, each group's 9 floats summed by a butterfly
//     of shuffles, one add per group and slot.  The mono kernel keeps a
//     slot set per warp in shared memory and needs no atomic: its
//     partials are the same from run to run.  The per-sample kernel,
//     whose tables may hold 640 primitives (four slot sets would take
//     92 KB), keeps one set per block, which the groups' leaders add to
//     atomically (per-warp sets were 4.6% faster at 7 spheres and 9.8%
//     slower at 500, chip_ab.py);
//   * the loss and camera sums go over the warp by shuffles and then over
//     the block's 4 warps in a fixed order.

// The per-ray code and its bit-level contract with the plain versions
// are in bounce.cuh, which the blockwise gradient kernel shares.

#include "bounce.cuh"

namespace {

constexpr int kCols = 10;  // [cx|nx, cy|ny, cz|nz, r|d, alb r g b, refl, rough, cls]
constexpr int kWarps = kThreads / 32;
constexpr int kRed = kCam + 1;  // block partials: the camera floats, then the loss

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

// The mono kernel keeps one slot set per warp (<= 96 primitives in the
// router, 13.8 KB at 96), the per-sample kernel one per block (up to 640
// primitives, where four sets would take 92 KB and cut the blocks per SM);
// rt_grad_fused sizes the shared memory to match.
template <bool kMono>
__device__ __forceinline__ void fused_body(const Args& A) {
  extern __shared__ float smem[];
  const int ns = A.n_spheres * kSSlots, np = A.n_planes * kPSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s_pl = smem;
  float* s_sp = s_pl + A.n_planes * kCols;
  float* acc = s_sp + A.n_spheres * kCols;  // n_sets slot sets of ns + np
  const int n_sets = kMono ? kWarps : 1;
  float* red = acc + n_sets * (ns + np);     // (kWarps, kRed)
  for (int i = threadIdx.x; i < A.n_planes * kCols; i += blockDim.x) s_pl[i] = A.planes[i];
  for (int i = threadIdx.x; i < A.n_spheres * kCols; i += blockDim.x) s_sp[i] = A.spheres[i];
  for (int i = threadIdx.x; i < n_sets * (ns + np); i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  float* acc_s = acc + (kMono ? warp * (ns + np) : 0);
  float* acc_p = acc_s + ns;

  const int n = A.width * A.height;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_frame = gid < n;
  const Cam cam = load_cam(A.cam);
  const float px = static_cast<float>(gid % A.width);
  const float py = static_cast<float>(gid / A.width);
  const uint32_t pix = static_cast<uint32_t>(gid);
  float loss = 0.0f;
  float cam_acc[kCam];
  for (int i = 0; i < kCam; ++i) cam_acc[i] = 0.0f;

  // ---- forward sweeps and the pixel cotangent ----
  float crad[3] = {0.0f, 0.0f, 0.0f};
  if (in_frame) {
    float img[3] = {0.0f, 0.0f, 0.0f};
    for (int s = 0; s < A.spp; ++s) {
      const uint32_t seed = static_cast<uint32_t>(A.seeds[s]);
      float jx = hash_u01(pix, seed, 1u), jy = hash_u01(pix, seed, 2u);
      if (s == 0 && A.center0) { jx = 0.5f; jy = 0.5f; }
      const RayParts rp = raygen_parts(cam, px, py, jx, jy, A.inv_w, A.inv_h);
      forward_sample<kCols>(s_pl, A.n_planes, s_sp, A.n_spheres, cam, rp, pix, seed, s, gid,
                            A.rng_sphere, A.stash, img);
    }
    if (kMono) {
      float diff[3];
      for (int c = 0; c < 3; ++c) diff[c] = img[c] * A.inv_spp - A.pix_in[gid * 3 + c];
      loss = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2];
      for (int c = 0; c < 3; ++c) crad[c] = diff[c] * A.cot_scale;
    } else {
      for (int c = 0; c < 3; ++c) crad[c] = A.pix_in[gid * 3 + c];
    }
  }

  // ---- reverse sweeps, warp-uniform ----
  // Every lane runs the warp's longest path: a lane past its own live
  // bounces, or past the frame, runs word 0 (the identity, no gradient)
  // and loads nothing, so all 32 lanes reach warp_add_prim_grad together.
  for (int s = 0; s < A.spp; ++s) {
    const uint32_t seed = static_cast<uint32_t>(A.seeds[s]);
    float co[3] = {0.0f, 0.0f, 0.0f}, cd[3] = {0.0f, 0.0f, 0.0f}, ct[3] = {0.0f, 0.0f, 0.0f};
    const int nb = in_frame ? A.stash.nb[static_cast<size_t>(s) * n + gid] : 0;
    for (int b = __reduce_max_sync(kFull, nb) - 1; b >= 0; --b) {
      float v[kStashF];
      uint32_t word = 0u;
      float ux = 0.0f, uy = 0.0f, uz = 0.0f;
      for (int k = 0; k < kStashF; ++k) v[k] = 0.0f;
      if (b < nb) {
        for (int k = 0; k < kStashF; ++k) v[k] = A.stash.f[A.stash.fi(s, b, k, gid)];
        word = static_cast<uint32_t>(A.stash.word[A.stash.wi(s, b, gid)]);
        unit_draws(pix, seed, b, A.rng_sphere, ux, uy, uz);
      }
      const PrimGrad g = bounce_adjoint<kCols>(s_pl, s_sp, v, word, ux, uy, uz, crad, co, cd, ct);
      warp_add_prim_grad<!kMono>(g, acc_s, acc_p, A.n_spheres, A.n_planes);
    }
    if (in_frame) {
      float jx = hash_u01(pix, seed, 1u), jy = hash_u01(pix, seed, 2u);
      if (s == 0 && A.center0) { jx = 0.5f; jy = 0.5f; }
      const RayParts rp = raygen_parts(cam, px, py, jx, jy, A.inv_w, A.inv_h);
      raygen_adjoint(cam, rp, co, cd, cam_acc);
    }
  }

  // ---- block partials: over the warp by shuffles, then over the warps in order ----
  for (int i = 0; i < kCam; ++i) {
    const float c = warp_sum(cam_acc[i]);
    if (lane == 0) red[warp * kRed + i] = c;
  }
  if (kMono) {
    const float l = warp_sum(loss);
    if (lane == 0) red[warp * kRed + kCam] = l;
  }
  __syncthreads();  // every partial and every slot add has landed
  for (int i = threadIdx.x; i < (kMono ? kRed : kCam); i += blockDim.x) {
    float t = red[i];
    for (int w = 1; w < kWarps; ++w) t = t + red[w * kRed + i];
    if (i < kCam) {
      A.cg_out[blockIdx.x * kCam + i] = t;
    } else {
      A.loss_out[blockIdx.x] = t;
    }
  }
  for (int i = threadIdx.x; i < ns + np; i += blockDim.x) {
    float t = acc[i];
    for (int w = 1; w < n_sets; ++w) t = t + acc[w * (ns + np) + i];
    if (i < ns) {
      A.sg_out[static_cast<size_t>(blockIdx.x) * ns + i] = t;
    } else {
      A.pg_out[static_cast<size_t>(blockIdx.x) * np + (i - ns)] = t;
    }
  }
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
                                       static_cast<size_t>(mono ? kWarps : 1) *
                                           (static_cast<size_t>(n_spheres) * kSSlots +
                                            static_cast<size_t>(n_planes) * kPSlots) +
                                       kWarps * kRed);
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
