// Scan-free reverse of one wavefront bounce, for Hopper (sm_90a).
//
// Replaces the TPU kernel rt_tpu/ops/pallas_wavefront_grad.py::
// _make_wf_rev_kernel (rng_impl="hash").  For bounce b > 0 it reads, per
// ray of the table that entered the bounce (the record forward of
// rt_tpu_torch/ops/wavefront_grad.py keeps it), the ray's state and its
// winner word, fetches the winner's payload from the table row, recomputes
// the hit distance and near-root bit with the scan's own float ops
// (_recompute_t), the decision bits (pallas_grad._decisions, as
// bounce.cuh's decisions() builds the stash word) and the draws from the
// counter hash, runs the hand-written adjoint of _bounce_smooth
// (bounce.cuh's bounce_adjoint) and adds the winner's payload cotangents
// to the step's per-row gradient tables.  bounce == 0 (the TPU kernel's
// gen=True) recomputes the camera ray and adds the raygen adjoint's camera
// cotangent.  No closest-hit scan runs in the reverse.
//
// As in JAX the recorded path is the forward kernel's (the render
// dielectric of trace.cuh), while the decisions and the adjoint follow
// pallas_grad (its cos_i dielectric): mirrored, not "fixed".
//
// Cotangents in ray-id order.  JAX carries the (12, N) cotangent table in
// the layout of the sorted state and moves it back through every sort
// with the recorded permutation (_sort_state_perm, _transport).  Here the
// cotangents of origin, direction and throughput live in one (9, n_rays)
// table indexed by ray id: a thread reads its ray's id from the saved
// state and reads and writes cot[id].  The sums are the same and no
// permutation is recorded or applied.  The pixel cotangent is read by the
// ray's pixel, cot_pix[id % n_pix], at every bounce.
//
// A shard of the chunk (the sharded step, make_wf_train_step(mesh=); the
// counterpart of the TPU kernel's ray_offset meta[5]) holds the rays ray0
// .. ray0 + n_rays - 1 of a chunk of `total` rays: its cotangent table is
// its own, indexed by id - ray0, the gen launch regenerates the rays ray0
// + j (ids at or past `total`, the last shard's padding, add nothing),
// and cot_pix stays the whole frame's (the gathered frame's cotangent).
// The whole chunk is ray0 = 0, total = n_rays.
//
// What bounds it on this card.  Per live ray and bounce: ~200-350 FP32
// operations of the adjoint, 56 bytes of saved state and word, 36 bytes
// of cotangent read and written, and the winner's 9 (sphere) or 5 (plane)
// gradient slots; no scan, so the reverse is a small share of a train step
// next to the forward's scans.  And the sums: with one float64 atomic per
// slot per ray, ablation builds (chip_ab.py; PERF.md) put 84% of the
// bounce-0 launch of a 1,036,800-ray chunk and 32% of the later ones in
// those atomics: camera rays in pixel order, most of a warp's lanes on the
// few rows the camera sees, so the adds to their addresses serialize.
// The design:
//   * one thread per ray of the saved table; a dead ray's bounce is the
//     identity on its cotangents and adds no gradient, so its lane skips
//     the adjoint (key -1) but still reaches the warp's sums; a warp whose
//     first lane lies past the live prefix leaves as a whole, and lanes
//     past the prefix read nothing;
//   * per-row gradients are summed per warp by winner first (bounce.cuh
//     warp_add_prim_grad: lanes grouped with __match_any_sync, each
//     group's slots summed by a butterfly of shuffles), and the groups'
//     leaders add to one float64 (9, S) and (5, P) table per step with
//     global atomics, as bw_grad_kernel.cu does (float32 atomics in varying
//     order reached half the card check's tolerance there);
//   * the camera sums of the gen launch go over the warp by shuffles, then
//     over the block's warps in a fixed order, and one float64 atomic per
//     block and float (bounce.cuh block_add_cam).

#include "bounce.cuh"

namespace {

constexpr int kCols = 16;  // padded row length of the tables

struct Args {
  const float* spheres; int n_spheres;
  const float* planes; int n_planes;
  const float* cam;       // (16,)
  const int32_t* seed;    // (1,) the chunk's seed
  const float* state;     // (13, n) state entering the bounce (b > 0)
  const int32_t* ids;     // (n,) (b > 0)
  const int32_t* words;   // (n,) winner words of the bounce
  const int32_t* limit;   // (1,) live-prefix length, or null (b > 0)
  float* cot;             // (9, n_rays): o, d, thr cotangents by ray id - ray0
  const float* cot_pix;   // (n_pix, 3)
  double* sg;             // (9, n_spheres), added to
  double* pg;             // (5, n_planes), added to
  double* cg;             // (16,), added to (gen)
  int n, n_rays, n_pix, width;
  int ray0, total;        // the table's first ray id, the chunk's rays
  float inv_w, inv_h;
  int bounce, max_bounces, center_sample, rng_sphere;
};

// Reverse of one live ray's bounce whose draws start after counter c:
// v = (o, d, thr) entering it, rec its winner word; co, cd, ct in place.
// Returns the winner's payload cotangents.
__device__ __forceinline__ PrimGrad reverse_ray(const Args& A, uint32_t pix, uint32_t seed,
                                                uint32_t c, const float v[kStashF], int32_t rec,
                                                float co[3], float cd[3], float ct[3]) {
  const float ox = v[0], oy = v[1], oz = v[2], dx = v[3], dy = v[4], dz = v[5];
  // the winner's distance and root bit (_recompute_t: the scan's float ops)
  float best = kBig;
  int win = 0;
  bool ispl = false, root = true;
  if (!(rec & kWordMiss)) {
    win = rec & kWordRow;
    ispl = (rec & kWordPlane) != 0;
    if (ispl) {
      const float* q = A.planes + win * kCols;
      const float nd = q[0] * dx + q[1] * dy + q[2] * dz;
      const float no = q[0] * ox + q[1] * oy + q[2] * oz + q[3];
      best = -no / (fabsf(nd) > 1e-12f ? nd : 1.0f);
    } else {
      const float* q = A.spheres + win * kCols;
      const float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
      const float bq = ocx * dx + ocy * dy + ocz * dz;
      const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
      const float disc = bq * bq - c0;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float t0 = -bq - sq;
      root = t0 >= kMinHit;
      best = root ? t0 : -bq + sq;
    }
  }
  float ux, uy, uz;
  unit_draws_at(pix, seed, c + 1u, A.rng_sphere, ux, uy, uz);
  const float coin = hash_u01(pix, seed, c + 4u);
  const uint32_t word = decisions<kCols>(A.planes, A.spheres, ox, oy, oz, dx, dy, dz, true, best,
                                         win, ispl, root, ux, uy, uz, coin);
  const float crad[3] = {A.cot_pix[pix * 3 + 0], A.cot_pix[pix * 3 + 1], A.cot_pix[pix * 3 + 2]};
  return bounce_adjoint<kCols>(A.planes, A.spheres, v, word, ux, uy, uz, crad, co, cd, ct);
}

__global__ void __launch_bounds__(kThreads) wf_rev_kernel(Args A) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = A.n;
  const int live_n = A.limit != nullptr ? min(n, *A.limit) : n;
  if ((j & ~31) >= live_n) return;  // the whole warp lies past the live prefix
  PrimGrad g;
  g.key = -1;
  const float* s = A.state + j;
  if (j < live_n && s[12 * n] > 0.0f) {  // a live ray; every lane reaches the warp's sums
    const uint32_t id = static_cast<uint32_t>(A.ids[j]);
    const uint32_t pix = id % static_cast<uint32_t>(A.n_pix);
    const uint32_t smp = id / static_cast<uint32_t>(A.n_pix);
    const uint32_t c = smp * (2u + 4u * static_cast<uint32_t>(A.max_bounces)) + 2u +
                       4u * static_cast<uint32_t>(A.bounce);
    float v[kStashF];
    for (int k = 0; k < kStashF; ++k) v[k] = s[k * n];
    float* cot = A.cot + (id - static_cast<uint32_t>(A.ray0));
    const int64_t m = A.n_rays;
    float co[3] = {cot[0 * m], cot[1 * m], cot[2 * m]};
    float cd[3] = {cot[3 * m], cot[4 * m], cot[5 * m]};
    float ct[3] = {cot[6 * m], cot[7 * m], cot[8 * m]};
    g = reverse_ray(A, pix, static_cast<uint32_t>(A.seed[0]), c, v, A.words[j], co, cd, ct);
    for (int k = 0; k < 3; ++k) {
      cot[k * m] = co[k];
      cot[(3 + k) * m] = cd[k];
      cot[(6 + k) * m] = ct[k];
    }
  }
  warp_add_prim_grad<true>(g, A.sg, A.pg, A.n_spheres, A.n_planes);
}

__global__ void __launch_bounds__(kThreads) wf_rev_gen_kernel(Args A) {
  __shared__ float red[kThreads / 32 * kCam];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float cam_acc[kCam];
  for (int i = 0; i < kCam; ++i) cam_acc[i] = 0.0f;
  PrimGrad g;
  g.key = -1;

  const int id = A.ray0 + j;
  if (j < A.n && id < A.total) {  // no early return: every lane reaches the sums below
    const uint32_t pix = static_cast<uint32_t>(id % A.n_pix);
    const uint32_t smp = static_cast<uint32_t>(id / A.n_pix);
    const uint32_t seed = static_cast<uint32_t>(A.seed[0]);
    const uint32_t base = smp * (2u + 4u * static_cast<uint32_t>(A.max_bounces));
    float jx = hash_u01(pix, seed, base + 1u), jy = hash_u01(pix, seed, base + 2u);
    if (smp == 0 && A.center_sample) { jx = 0.5f; jy = 0.5f; }
    const Cam cam = load_cam(A.cam);
    const RayParts rp = raygen_parts(cam, static_cast<float>(pix % A.width),
                                     static_cast<float>(pix / A.width), jx, jy, A.inv_w,
                                     A.inv_h);
    const float v[kStashF] = {cam.cp[0] + rp.dwx * cam.near, cam.cp[1] + rp.dwy * cam.near,
                              cam.cp[2] + rp.dwz * cam.near, rp.dwx * rp.inv, rp.dwy * rp.inv,
                              rp.dwz * rp.inv, 1.0f, 1.0f, 1.0f};
    const float* cot = A.cot + j;
    const int64_t m = A.n_rays;
    float co[3] = {cot[0 * m], cot[1 * m], cot[2 * m]};
    float cd[3] = {cot[3 * m], cot[4 * m], cot[5 * m]};
    float ct[3] = {cot[6 * m], cot[7 * m], cot[8 * m]};
    g = reverse_ray(A, pix, seed, base + 2u, v, A.words[j], co, cd, ct);
    raygen_adjoint(cam, rp, co, cd, cam_acc);
  }
  warp_add_prim_grad<true>(g, A.sg, A.pg, A.n_spheres, A.n_planes);
  block_add_cam(red, cam_acc, A.cg);
}

}  // namespace

// Launches one call on `stream`; returns cudaGetLastError() as an int.
// Tables are row-major float32 (rows, 16), of which the first n_* rows are
// used; cam (16,) float32, seed (1,) int32; state (13, n) float32, ids (n,)
// int32 and limit (1,) int32 or null (unused when bounce == 0); words (n,)
// int32; cot (9, n_rays) float32 by ray id - ray0, updated in place (bounce
// > 0); cot_pix (n_pix, 3) float32; the table holds rays of ids ray0 ..
// ray0 + n_rays - 1 of a chunk of `total` rays (bounce 0 regenerates ray0
// + j).  sg (9, n_spheres), pg (5, n_planes) and cg (16,), float64, are
// added to (cg by bounce 0 only).
extern "C" int rt_wf_rev(const float* spheres, int n_spheres, const float* planes, int n_planes,
                         const float* cam, const int32_t* seed, const float* state,
                         const int32_t* ids, const int32_t* words, const int32_t* limit, float* cot,
                         const float* cot_pix, double* sg, double* pg, double* cg, int n,
                         int n_rays, int ray0, int total, int n_pix, int width, float inv_w,
                         float inv_h, int bounce, int max_bounces, int center_sample,
                         int rng_sphere, void* stream) {
  Args a;
  a.spheres = spheres; a.n_spheres = n_spheres;
  a.planes = planes; a.n_planes = n_planes;
  a.cam = cam; a.seed = seed;
  a.state = state; a.ids = ids; a.words = words; a.limit = limit;
  a.cot = cot; a.cot_pix = cot_pix;
  a.sg = sg; a.pg = pg; a.cg = cg;
  a.n = n; a.n_rays = n_rays; a.n_pix = n_pix; a.width = width;
  a.ray0 = ray0; a.total = total;
  a.inv_w = inv_w; a.inv_h = inv_h;
  a.bounce = bounce; a.max_bounces = max_bounces; a.center_sample = center_sample;
  a.rng_sphere = rng_sphere;
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bounce == 0) {
    wf_rev_gen_kernel<<<blocks, kThreads, 0, s>>>(a);
  } else {
    wf_rev_kernel<<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Marks a library whose rt_wf_rev takes the table's first ray id and the
// chunk's rays (the sharded routes' interface): tools that load libraries
// built from other trees check for it.
extern "C" int rt_wf_rev_offsets() { return 1; }
