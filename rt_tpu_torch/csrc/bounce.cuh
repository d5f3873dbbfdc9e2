// Per-ray device math of the gradient kernels, shared by grad_kernel.cu
// (tables in shared memory, rows of 10 floats), bw_grad_kernel.cu and
// wf_grad_kernel.cu (tables in device memory, rows of 16 floats): the
// raygen and its adjoint, the closest-hit scan and its replay from a
// forward kernel's winner word, the decision bits of a bounce
// (decisions), the forward sweep with its stash, the hand-written adjoint
// of one bounce, and the per-warp sums of its gradients.
//
// Bit-level contract (with grad_tile_plain / mse_step_tile_plain in
// rt_tpu_torch/ops/grad.py and rt_tpu_torch/ops/_grad_math.py, which
// write every expression in the same order):
//   * the forward bounce is pallas_grad's _bounce_forward (its dielectric
//     differs from the render kernel's: cos_i = inside ? ddot : -ddot and
//     cos_t = sqrt(tir ? 1 : max(1 - sin2, 1e-12)));
//   * draws: each sample restarts its counter with its own seed; jitter
//     at counters 1, 2 (drawn even for the centre sample), bounce b's unit
//     vector at 3+4b .. 5+4b and its coin at 6+4b (the wavefront reverse
//     offsets them by its sample's base, as the wavefront forward does);
//   * rsqrt is 1/sqrtf; the library is built with --fmad=false;
//   * the adjoint is a hand-written transpose of pallas_grad's
//     _bounce_smooth with every decision pinned; a where() of the plain
//     version is an `if` here wherever the branch not taken contributes
//     exact zeros.  Ties of the max(x, eps) gates go to the '>' side.

#pragma once

#include "common.cuh"

namespace {

constexpr int kStashF = 9;   // o, d, thr
constexpr int kSSlots = 9;   // sphere gradient slots
constexpr int kPSlots = 5;   // plane gradient slots (material only)
constexpr int kCam = 16;     // camera gradient floats (15 + padding)

// bits of the packed stash word (rt_tpu_torch/ops/_grad_math.py BITS); the
// winner's row rides bits 16..31
enum : uint32_t {
  kHit = 1u << 0, kLiveH = 1u << 1, kMiss = 1u << 2, kAlive = 1u << 3,
  kIsPl = 1u << 4, kRoot = 1u << 5, kLdeg = 1u << 6, kRefl = 1u << 7,
  kTir = 1u << 8, kInside = 1u << 9, kIsMet = 1u << 10, kIsDie = 1u << 11,
};
constexpr int kWinShift = 16;

struct Cam {
  float cp[3], r[9], tan_half, aspect, near;
};

// The 16-float camera vector: position, row-major rotation, tan(vfov/2),
// aspect, near, padding.
__device__ __forceinline__ Cam load_cam(const float* c) {
  Cam cam;
  for (int i = 0; i < 3; ++i) cam.cp[i] = c[i];
  for (int i = 0; i < 9; ++i) cam.r[i] = c[3 + i];
  cam.tan_half = c[12]; cam.aspect = c[13]; cam.near = c[14];
  return cam;
}

// Scatter unit vector drawn at counters c .. c+2.
__device__ __forceinline__ void unit_draws_at(uint32_t pix, uint32_t seed, uint32_t c,
                                              int rng_sphere, float& ux, float& uy, float& uz) {
  ux = hash_u01(pix, seed, c);
  uy = hash_u01(pix, seed, c + 1u);
  uz = hash_u01(pix, seed, c + 2u);
  if (rng_sphere) {
    ux = 2.0f * ux - 1.0f; uy = 2.0f * uy - 1.0f; uz = 2.0f * uz - 1.0f;
  }
  const float uinv = rsqrt_rn(fmaxf(ux * ux + uy * uy + uz * uz, 1e-30f));
  ux = ux * uinv; uy = uy * uinv; uz = uz * uinv;
}

// Scatter unit vector of bounce b of a sample with its own seed (counters
// 3+4b .. 5+4b).
__device__ __forceinline__ void unit_draws(uint32_t pix, uint32_t seed, int b, int rng_sphere,
                                           float& ux, float& uy, float& uz) {
  unit_draws_at(pix, seed, 3u + 4u * static_cast<uint32_t>(b), rng_sphere, ux, uy, uz);
}

struct RayParts {
  float nxn, nyn, a, dvx, dvy, dwx, dwy, dwz, inv;
};

__device__ __forceinline__ RayParts raygen_parts(const Cam& c, float px, float py, float jx,
                                                 float jy, float inv_w, float inv_h) {
  RayParts q;
  q.nxn = 2.0f * (px + jx) * inv_w - 1.0f;
  q.nyn = 1.0f - 2.0f * (py + jy) * inv_h;
  q.a = q.nxn * c.tan_half;
  q.dvx = q.a * c.aspect;
  q.dvy = q.nyn * c.tan_half;
  q.dwx = c.r[0] * q.dvx + c.r[1] * q.dvy - c.r[2];
  q.dwy = c.r[3] * q.dvx + c.r[4] * q.dvy - c.r[5];
  q.dwz = c.r[6] * q.dvx + c.r[7] * q.dvy - c.r[8];
  q.inv = rsqrt_rn(q.dwx * q.dwx + q.dwy * q.dwy + q.dwz * q.dwz);
  return q;
}

// Cotangents of the 15 camera floats from those of the ray (adds to acc).
__device__ __forceinline__ void raygen_adjoint(const Cam& c, const RayParts& q, const float co[3],
                                               const float cd[3], float acc[kCam]) {
  const float kd = q.inv * q.inv * q.inv * (q.dwx * cd[0] + q.dwy * cd[1] + q.dwz * cd[2]);
  const float cdwx = co[0] * c.near + (q.inv * cd[0] - kd * q.dwx);
  const float cdwy = co[1] * c.near + (q.inv * cd[1] - kd * q.dwy);
  const float cdwz = co[2] * c.near + (q.inv * cd[2] - kd * q.dwz);
  const float cnear = q.dwx * co[0] + q.dwy * co[1] + q.dwz * co[2];
  const float cdvx = c.r[0] * cdwx + c.r[3] * cdwy + c.r[6] * cdwz;
  const float cdvy = c.r[1] * cdwx + c.r[4] * cdwy + c.r[7] * cdwz;
  const float ctan = cdvx * c.aspect * q.nxn + cdvy * q.nyn;
  const float caspect = cdvx * q.a;
  const float g[15] = {co[0], co[1], co[2],
                       cdwx * q.dvx, cdwx * q.dvy, -cdwx,
                       cdwy * q.dvx, cdwy * q.dvy, -cdwy,
                       cdwz * q.dvx, cdwz * q.dvy, -cdwz,
                       ctan, caspect, cnear};
  for (int i = 0; i < 15; ++i) acc[i] = acc[i] + g[i];
}

// Closest hit (pallas_grad _make_scan): planes first with strict '<', a
// sphere wins a tie against a plane, strict '<' among spheres.  Tables are
// row-major with rows of kStride floats.
template <int kStride>
__device__ __forceinline__ void scan(const float* s_pl, int n_planes, const float* s_sp,
                                     int n_spheres, float ox, float oy, float oz, float dx,
                                     float dy, float dz, float& best, int& win, bool& ispl,
                                     bool& root) {
  best = kBig; win = 0; ispl = false; root = true;
  for (int p = 0; p < n_planes; ++p) {
    const float* q = s_pl + p * kStride;
    const float nd = q[0] * dx + q[1] * dy + q[2] * dz;
    const float no = q[0] * ox + q[1] * oy + q[2] * oz + q[3];
    if (fabsf(nd) > 1e-12f) {
      const float t = -no / nd;
      if (t >= kMinHit && t < best) { best = t; win = p; ispl = true; }
    }
  }
  for (int i = 0; i < n_spheres; ++i) {
    const float* q = s_sp + i * kStride;
    const float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
    const float bq = ocx * dx + ocy * dy + ocz * dz;
    const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
    const float disc = bq * bq - c0;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -bq - sq;
    const float t1 = -bq + sq;
    const bool near = t0 >= kMinHit;
    const float t = near ? t0 : t1;
    if (disc >= 0.0f && t >= kMinHit && (t < best || (t == best && ispl))) {
      best = t; win = i; ispl = false; root = near;
    }
  }
}

// The scan's result from the forward kernel's winner word of the same
// bounce (common.cuh kWord*; no boxes here): the winner's own test, the
// scan's expressions on that one row.  A plane gives -no / nd; a sphere
// t0 if t0 >= kMinHit, else t1, and its root flag; a miss kBig.  So `best`,
// `win`, `ispl` and `root` are bit for bit what scan() returns, whenever
// the ray is the one the forward kernel traced.
template <int kStride>
__device__ __forceinline__ void replay_winner(const float* s_pl, const float* s_sp, int32_t word,
                                              float ox, float oy, float oz, float dx, float dy,
                                              float dz, float& best, int& win, bool& ispl,
                                              bool& root) {
  best = kBig; win = 0; ispl = false; root = true;
  if (word & kWordMiss) return;
  win = word & kWordRow;
  if (word & kWordPlane) {
    const float* q = s_pl + win * kStride;
    const float nd = q[0] * dx + q[1] * dy + q[2] * dz;
    const float no = q[0] * ox + q[1] * oy + q[2] * oz + q[3];
    best = -no / nd;
    ispl = true;
  } else {
    const float* q = s_sp + win * kStride;
    const float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
    const float bq = ocx * dx + ocy * dy + ocz * dz;
    const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
    const float disc = bq * bq - c0;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -bq - sq;
    const float t1 = -bq + sq;
    root = t0 >= kMinHit;
    best = root ? t0 : t1;
  }
}

struct Stash {
  float* f;            // [spp][B][9][n]
  int32_t* word;       // [spp][B][n]
  int32_t* nb;         // [spp][n]
  int n, max_bounces;
  __device__ __forceinline__ size_t fi(int s, int b, int k, int gid) const {
    return ((static_cast<size_t>(s) * max_bounces + b) * kStashF + k) * n + gid;
  }
  __device__ __forceinline__ size_t wi(int s, int b, int gid) const {
    return (static_cast<size_t>(s) * max_bounces + b) * n + gid;
  }
};

// Decision bits of one bounce (pallas_grad._decisions), packed as the
// stash word with the winner's row in bits 16..31: from the ray entering
// the bounce (o, d), whether it is live, the scan's winner (distance
// `best`, row, plane or sphere, near root) and the bounce's unit vector
// and coin.  A ray that is not a live hit gets its hit, miss, plane and
// root bits only: the adjoint reads no other bit of it.
template <int kStride>
__device__ __forceinline__ uint32_t decisions(const float* s_pl, const float* s_sp, float ox,
                                              float oy, float oz, float dx, float dy, float dz,
                                              bool live, float best, int win, bool ispl,
                                              bool root, float ux, float uy, float uz,
                                              float coin) {
  const bool hit = best < 1e37f;
  uint32_t bits = (hit ? kHit : 0u) | (ispl ? kIsPl : 0u) | (root ? kRoot : 0u) |
                  (static_cast<uint32_t>(win) << kWinShift);
  if (!live) return bits;
  if (!hit) return bits | kMiss;
  bits |= kLiveH;
  const float hx = ox + best * dx, hy = oy + best * dy, hz = oz + best * dz;
  float nx, ny, nz;
  const float* q = (ispl ? s_pl : s_sp) + win * kStride;
  if (ispl) {
    nx = q[0]; ny = q[1]; nz = q[2];
  } else {
    const float snx = hx - q[0], sny = hy - q[1], snz = hz - q[2];
    const float sinv = rsqrt_rn(fmaxf(snx * snx + sny * sny + snz * snz, 1e-30f));
    nx = snx * sinv; ny = sny * sinv; nz = snz * sinv;
  }
  const float brf = q[7], brg = q[8], cls = q[9];
  const float lx = nx + ux, ly = ny + uy, lz = nz + uz;
  if (lx * lx + ly * ly + lz * lz < 1e-16f) bits |= kLdeg;
  bool alive = true;
  if (cls == 1.0f) {
    // metal (mg_ray_tracer.cpp:125-140): absorbed when the lobe dips under
    bits |= kIsMet;
    const float ddot = dx * nx + dy * ny + dz * nz;
    const float mx = dx - 2.0f * ddot * nx + brg * ux;
    const float my = dy - 2.0f * ddot * ny + brg * uy;
    const float mz = dz - 2.0f * ddot * nz + brg * uz;
    alive = !((mx * nx + my * ny + mz * nz) <= 0.0f);
  } else if (cls == 2.0f) {
    // dielectric (sm_ray_tracer.cpp:181-219): inside, TIR and the Fresnel coin
    bits |= kIsDie;
    const float ddot = dx * nx + dy * ny + dz * nz;
    const bool inside = ddot > 0.0f;
    const float eta = inside ? brf : 1.0f / fmaxf(brf, 1e-12f);
    const float cosine = inside ? brf * ddot : -ddot;
    const float cos_i = inside ? ddot : -ddot;
    const float sin2 = eta * eta * (1.0f - cos_i * cos_i);
    const bool tir = sin2 > 1.0f;
    float r0 = (1.0f - brf) / (1.0f + brf);
    r0 = r0 * r0;
    const float omc = 1.0f - cosine;
    const float omc2 = omc * omc;
    const float prob = tir ? 1.0f : r0 + (1.0f - r0) * omc2 * omc2 * omc;
    if (inside) bits |= kInside;
    if (tir) bits |= kTir;
    if (coin < prob) bits |= kRefl;
  }
  return alive ? bits | kAlive : bits;
}

// One sample's forward sweep: stashes every bounce the ray lives through
// and adds its sky radiance to acc.  The stash word is decisions()'s, and
// the advance follows its bits.  The words form (kWords) takes each
// bounce's winner from the forward kernel's winner words of this sample,
// words[b * st.n + gid] (replay_winner), in place of the scan.
template <int kStride, bool kWords = false>
__device__ void forward_sample(const float* s_pl, int n_planes, const float* s_sp, int n_spheres,
                               const Cam& cam, const RayParts& rp, uint32_t pix, uint32_t seed,
                               int s, int gid, int rng_sphere, const Stash& st, float acc[3],
                               const int32_t* __restrict__ words = nullptr) {
  float ox = cam.cp[0] + rp.dwx * cam.near;
  float oy = cam.cp[1] + rp.dwy * cam.near;
  float oz = cam.cp[2] + rp.dwz * cam.near;
  float dx = rp.dwx * rp.inv, dy = rp.dwy * rp.inv, dz = rp.dwz * rp.inv;
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  int b = 0;
  for (; b < st.max_bounces; ++b) {
    float best; int win; bool ispl, root;
    if constexpr (kWords) {
      replay_winner<kStride>(s_pl, s_sp, words[static_cast<size_t>(b) * st.n + gid], ox, oy, oz,
                             dx, dy, dz, best, win, ispl, root);
    } else {
      scan<kStride>(s_pl, n_planes, s_sp, n_spheres, ox, oy, oz, dx, dy, dz, best, win, ispl,
                    root);
    }
    const float vals[kStashF] = {ox, oy, oz, dx, dy, dz, tr, tg, tb};
    for (int k = 0; k < kStashF; ++k) st.f[st.fi(s, b, k, gid)] = vals[k];
    float ux = 0.0f, uy = 0.0f, uz = 0.0f, coin = 0.0f;
    if (best < 1e37f) {
      unit_draws(pix, seed, b, rng_sphere, ux, uy, uz);
      coin = hash_u01(pix, seed, 6u + 4u * static_cast<uint32_t>(b));
    }
    const uint32_t bits = decisions<kStride>(s_pl, s_sp, ox, oy, oz, dx, dy, dz, true, best, win,
                                             ispl, root, ux, uy, uz, coin);
    st.word[st.wi(s, b, gid)] = static_cast<int32_t>(bits);

    if (bits & kMiss) {  // miss: sky (mg_ray_tracer.cpp:164), the path ends
      const float ts = 0.5f * (dy + 1.0f);
      acc[0] = acc[0] + tr * (1.0f - 0.5f * ts);
      acc[1] = acc[1] + tg * (1.0f - 0.3f * ts);
      acc[2] = acc[2] + tb;
      ++b;
      break;
    }
    const float hx = ox + best * dx, hy = oy + best * dy, hz = oz + best * dz;
    float nx, ny, nz;
    const float* pay;  // albedo r, g, b, reflectivity, roughness, class
    if (ispl) {
      const float* q = s_pl + win * kStride;
      nx = q[0]; ny = q[1]; nz = q[2];
      pay = q + 4;
    } else {
      const float* q = s_sp + win * kStride;
      const float snx = hx - q[0], sny = hy - q[1], snz = hz - q[2];
      const float sinv = rsqrt_rn(fmaxf(snx * snx + sny * sny + snz * snz, 1e-30f));
      nx = snx * sinv; ny = sny * sinv; nz = snz * sinv;
      pay = q + 4;
    }
    const float bar = pay[0], bag = pay[1], bab = pay[2], brf = pay[3], brg = pay[4];

    float ndx, ndy, ndz;
    if (bits & kIsMet) {
      // metal (mg_ray_tracer.cpp:125-140)
      const float ddot = dx * nx + dy * ny + dz * nz;
      const float mx = dx - 2.0f * ddot * nx + brg * ux;
      const float my = dy - 2.0f * ddot * ny + brg * uy;
      const float mz = dz - 2.0f * ddot * nz + brg * uz;
      const float minv = rsqrt_rn(fmaxf(mx * mx + my * my + mz * mz, 1e-30f));
      ndx = mx * minv; ndy = my * minv; ndz = mz * minv;
    } else if (bits & kIsDie) {
      // dielectric (sm_ray_tracer.cpp:181-219), as pallas_grad writes it
      const float ddot = dx * nx + dy * ny + dz * nz;
      const float rx = dx - 2.0f * ddot * nx;
      const float ry = dy - 2.0f * ddot * ny;
      const float rz = dz - 2.0f * ddot * nz;
      const bool inside = bits & kInside, tir = bits & kTir;
      const float sgn = inside ? -1.0f : 1.0f;
      const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
      const float eta = inside ? brf : 1.0f / fmaxf(brf, 1e-12f);
      const float cos_i = inside ? ddot : -ddot;
      const float sin2 = eta * eta * (1.0f - cos_i * cos_i);
      const float cos_t = tir ? 0.0f : sqrtf(fmaxf(1.0f - sin2, 1e-12f));
      const float ecc = eta * cos_i - cos_t;
      float gx, gy, gz;
      if (bits & kRefl) {
        gx = rx; gy = ry; gz = rz;
      } else {
        gx = eta * dx + ecc * onx; gy = eta * dy + ecc * ony; gz = eta * dz + ecc * onz;
      }
      const float ginv = rsqrt_rn(fmaxf(gx * gx + gy * gy + gz * gz, 1e-30f));
      ndx = gx * ginv; ndy = gy * ginv; ndz = gz * ginv;
    } else if (bits & kLdeg) {
      // lambert (mg_ray_tracer.cpp:109-123), degenerate -> normal
      ndx = nx; ndy = ny; ndz = nz;
    } else {
      const float lx = nx + ux, ly = ny + uy, lz = nz + uz;
      const float linv = rsqrt_rn(lx * lx + ly * ly + lz * lz);
      ndx = lx * linv; ndy = ly * linv; ndz = lz * linv;
    }
    const bool alive = bits & kAlive;
    if (alive) {
      tr = tr * (bar * brf);
      tg = tg * (bag * brf);
      tb = tb * (bab * brf);
    }
    ox = hx; oy = hy; oz = hz;
    dx = ndx; dy = ndy; dz = ndz;
    if (!alive) { ++b; break; }  // metal absorbed: the path ends
  }
  st.nb[static_cast<size_t>(s) * st.n + gid] = b;
}

// The winner's payload cotangents of one bounce: key = 2 * row + 1 for a
// plane, 2 * row for a sphere, -1 unless the ray hit while live (and then
// g is not set); g holds the 9 sphere slots (centre x/y/z, radius, albedo
// r/g/b, reflectivity, roughness), and for a plane zeros and then its 5
// material slots, so that g[4 + k] is material slot k of either.
struct PrimGrad {
  int key;
  float g[kSSlots];
};

template <bool kAtomic, typename Acc>
__device__ __forceinline__ void add_acc(Acc* a, Acc v) {
  if (kAtomic) {
    atomicAdd(a, v);
  } else {
    *a = *a + v;
  }
}

// Adds p to slot-major tables (slot k of row i at k * n + i: sphere (9, S),
// plane material (5, P)), slot by slot: with atomicAdd (kAtomic), or with
// plain adds where no other thread adds to the tables; Acc is float or
// double.
template <bool kAtomic = true, typename Acc>
__device__ __forceinline__ void add_prim_grad(const PrimGrad& p, Acc* acc_s, Acc* acc_p,
                                              int n_spheres, int n_planes) {
  if (p.key < 0) return;
  const int row = p.key >> 1;
  if (p.key & 1) {
    for (int k = 0; k < kPSlots; ++k)
      add_acc<kAtomic>(acc_p + k * n_planes + row, static_cast<Acc>(p.g[4 + k]));
  } else {
    for (int k = 0; k < kSSlots; ++k)
      add_acc<kAtomic>(acc_s + k * n_spheres + row, static_cast<Acc>(p.g[k]));
  }
}

constexpr unsigned kFull = 0xffffffffu;

// Sum of v over the warp by a butterfly of shuffles: every lane gets the
// same sum, added in the same fixed order.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

// Adds one bounce's payload cotangents of the warp's 32 lanes to the slot
// tables (acc_s, acc_p) through add_prim_grad.  All 32 lanes call it
// together.  The lanes are grouped by winner; a lane alone in its group
// adds its own values, and each larger group sums its values with a
// butterfly (warp_sum over the group's values, zeros elsewhere) whose
// lowest lane then adds the sums.  So each slot takes at most one add per
// warp and bounce.  With a slot set per warp (kAtomic false: the mono
// kernel's) the adds need no atomic and land in a fixed order; with
// kAtomic the group leaders add atomically, to the per-sample kernel's
// per-block set in shared memory (at most 4-way contention) or to the
// blockwise gradient kernel's float64 tables in device memory (Acc
// double), where most lanes of a warp hit the same sphere.
template <bool kAtomic, typename Acc>
__device__ __forceinline__ void warp_add_prim_grad(const PrimGrad& p, Acc* acc_s, Acc* acc_p,
                                                   int n_spheres, int n_planes) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, p.key);
  const bool live = p.key >= 0;
  const bool alone = __popc(peers) == 1;
  if (live && alone) add_prim_grad<kAtomic>(p, acc_s, acc_p, n_spheres, n_planes);
  for (unsigned todo = __ballot_sync(kFull, live && !alone); todo != 0;) {
    const int leader = __ffs(todo) - 1;
    const unsigned group = __shfl_sync(kFull, peers, leader);
    const bool in = (group >> lane) & 1u;
    PrimGrad sum;
    sum.key = p.key;
    for (int k = 0; k < kSSlots; ++k) sum.g[k] = warp_sum(in ? p.g[k] : 0.0f);
    if (lane == leader) add_prim_grad<kAtomic>(sum, acc_s, acc_p, n_spheres, n_planes);
    todo &= ~group;
  }
  __syncwarp();  // the next call's adds see these
}

// Hand-written transpose of one pinned bounce (pallas_grad _bounce_smooth),
// in place on the carried cotangents co, cd, ct; crad is the pixel
// cotangent.  Returns the winner's payload cotangents (PrimGrad) for the
// caller to add.  word 0 (no bit set) is the exact identity on co, cd and
// ct and returns key -1: not live_h, not miss and not alive, every
// cotangent is copied through untouched, and no other branch runs.
template <int kStride>
__device__ PrimGrad bounce_adjoint(const float* s_pl, const float* s_sp, const float v[kStashF],
                                   uint32_t word, float ux, float uy, float uz,
                                   const float crad[3], float co[3], float cd[3], float ct[3]) {
  PrimGrad pg;
  pg.key = -1;
  const float ox = v[0], oy = v[1], oz = v[2], dx = v[3], dy = v[4], dz = v[5];
  const float tr = v[6], tg = v[7], tb = v[8];
  const bool live_h = word & kLiveH, miss = word & kMiss, alive = word & kAlive;
  const bool ispl = word & kIsPl;
  const int win = static_cast<int>((word >> kWinShift) & 0xFFFFu);
  const float* q = live_h ? (ispl ? s_pl : s_sp) + win * kStride : nullptr;
  const float bar = live_h ? q[4] : 0.0f, bag = live_h ? q[5] : 0.0f;
  const float bab = live_h ? q[6] : 0.0f, brf = live_h ? q[7] : 1.0f;
  const float brg = live_h ? q[8] : 0.0f;
  const float ctr_ = ct[0], ctg_ = ct[1], ctb_ = ct[2];

  // o' = nlh o + lh h ; d' = nlh d + lh nd
  float cox = live_h ? 0.0f : co[0], coy = live_h ? 0.0f : co[1], coz = live_h ? 0.0f : co[2];
  float chx = live_h ? co[0] : 0.0f, chy = live_h ? co[1] : 0.0f, chz = live_h ? co[2] : 0.0f;
  float cdx = live_h ? 0.0f : cd[0], cdy = live_h ? 0.0f : cd[1], cdz = live_h ? 0.0f : cd[2];
  float cndx = live_h ? cd[0] : 0.0f, cndy = live_h ? cd[1] : 0.0f, cndz = live_h ? cd[2] : 0.0f;

  // thr'_c = thr_c (naf + af alb_c brf)
  float ctr = alive ? ctr_ * (bar * brf) : ctr_;
  float ctg = alive ? ctg_ * (bag * brf) : ctg_;
  float ctb = alive ? ctb_ * (bab * brf) : ctb_;
  float cbar = 0.0f, cbag = 0.0f, cbab = 0.0f, cbrf = 0.0f;
  if (alive) {
    cbar = ctr_ * tr * brf;
    cbag = ctg_ * tg * brf;
    cbab = ctb_ * tb * brf;
    cbrf = ctr_ * tr * bar + ctg_ * tg * bag + ctb_ * tb * bab;
  }
  // sky on miss
  if (miss) {
    const float ts = 0.5f * (dy + 1.0f);
    ctr = ctr + crad[0] * (1.0f - 0.5f * ts);
    ctg = ctg + crad[1] * (1.0f - 0.3f * ts);
    ctb = ctb + crad[2];
    cdy = cdy + 0.5f * (tr * (-0.5f) * crad[0] + tg * (-0.3f) * crad[1]);
  }

  if (live_h) {
    // ---- primal recompute (hit point from the smooth t) ----
    float t, ocx = 0.0f, ocy = 0.0f, ocz = 0.0f, bq = 0.0f, disc = 0.0f, sq = 0.0f;
    float pnx = 0.0f, pny = 0.0f, pnz = 0.0f, safe = 1.0f;
    bool nz_ok = false;
    const bool root = word & kRoot;
    if (ispl) {
      pnx = q[0]; pny = q[1]; pnz = q[2];
      const float ndd = pnx * dx + pny * dy + pnz * dz;
      nz_ok = fabsf(ndd) > 1e-12f;
      safe = nz_ok ? ndd : 1.0f;
      const float num = pnx * ox + pny * oy + pnz * oz + q[3];
      t = -num / safe;
    } else {
      ocx = ox - q[0]; ocy = oy - q[1]; ocz = oz - q[2];
      bq = ocx * dx + ocy * dy + ocz * dz;
      const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
      disc = bq * bq - c0;
      sq = sqrtf(fmaxf(disc, 1e-12f));
      t = root ? -bq - sq : -bq + sq;
    }
    const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;
    float nx, ny, nz, snx = 0.0f, sny = 0.0f, snz = 0.0f, sn2 = 0.0f, sinv = 0.0f;
    if (ispl) {
      nx = pnx; ny = pny; nz = pnz;
    } else {
      snx = hx - q[0]; sny = hy - q[1]; snz = hz - q[2];
      sn2 = snx * snx + sny * sny + snz * snz;
      sinv = rsqrt_rn(fmaxf(sn2, 1e-30f));
      nx = snx * sinv; ny = sny * sinv; nz = snz * sinv;
    }

    // ---- scatter transpose, by material class ----
    float cnx = 0.0f, cny = 0.0f, cnz = 0.0f, cbrg = 0.0f;
    if (word & (kIsDie | kIsMet)) {
      const float ddot = dx * nx + dy * ny + dz * nz;
      const float rx = dx - 2.0f * ddot * nx;
      const float ry = dy - 2.0f * ddot * ny;
      const float rz = dz - 2.0f * ddot * nz;
      float crx, cry, crz, cddot;
      if (word & kIsDie) {
        const bool inside = word & kInside, tir = word & kTir, refl = word & kRefl;
        const float sgn = inside ? -1.0f : 1.0f;
        const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
        const float mbrf = fmaxf(brf, 1e-12f);
        const float eta = inside ? brf : 1.0f / mbrf;
        const float cos_i = inside ? ddot : -ddot;
        const float sin2 = eta * eta * (1.0f - cos_i * cos_i);
        const float sct = sqrtf(tir ? 1.0f : fmaxf(1.0f - sin2, 1e-12f));
        const float cos_t = tir ? 0.0f : sct;
        const float ecc = eta * cos_i - cos_t;
        float gx, gy, gz;
        if (refl) {
          gx = rx; gy = ry; gz = rz;
        } else {
          gx = eta * dx + ecc * onx; gy = eta * dy + ecc * ony; gz = eta * dz + ecc * onz;
        }
        const float g2 = gx * gx + gy * gy + gz * gz;
        const float ginv = rsqrt_rn(fmaxf(g2, 1e-30f));
        // gg = g ginv
        const float gate_g = g2 > 1e-30f ? 1.0f : 0.0f;
        const float dot_gc = gx * cndx + gy * cndy + gz * cndz;
        const float k_g = gate_g * ginv * ginv * ginv * dot_gc;
        const float cgx = ginv * cndx - k_g * gx;
        const float cgy = ginv * cndy - k_g * gy;
        const float cgz = ginv * cndz - k_g * gz;
        // g = where(refl, r, f) ; f = eta d + (eta cos_i - cos_t) on
        crx = refl ? cgx : 0.0f; cry = refl ? cgy : 0.0f; crz = refl ? cgz : 0.0f;
        const float cfx = refl ? 0.0f : cgx, cfy = refl ? 0.0f : cgy, cfz = refl ? 0.0f : cgz;
        const float dot_fd = cfx * dx + cfy * dy + cfz * dz;
        const float dot_fon = cfx * onx + cfy * ony + cfz * onz;
        float ceta = dot_fd + cos_i * dot_fon;
        float ccos_i = eta * dot_fon;
        const float ccos_t = -dot_fon;
        cdx = cdx + eta * cfx; cdy = cdy + eta * cfy; cdz = cdz + eta * cfz;
        const float conx = ecc * cfx, cony = ecc * cfy, conz = ecc * cfz;
        // cos_t = where(tir, 0, sqrt(wct)), wct = where(tir, 1, max(1 - sin2, 1e-12))
        const float cs = tir ? 0.0f : ccos_t;
        const float cw = 0.5f * cs / sct;
        const float csin2 = (!tir && (1.0f - sin2) > 1e-12f) ? -cw : 0.0f;
        ceta = ceta + 2.0f * eta * (1.0f - cos_i * cos_i) * csin2;
        ccos_i = ccos_i - 2.0f * eta * eta * cos_i * csin2;
        cddot = inside ? ccos_i : -ccos_i;
        cbrf = cbrf + (inside ? ceta : (brf > 1e-12f ? -ceta / (mbrf * mbrf) : 0.0f));
        cnx = sgn * conx; cny = sgn * cony; cnz = sgn * conz;
      } else {
        // metal: mm = m minv, m = r + brg u
        const float mx = rx + brg * ux, my = ry + brg * uy, mz = rz + brg * uz;
        const float m2 = mx * mx + my * my + mz * mz;
        const float minv = rsqrt_rn(fmaxf(m2, 1e-30f));
        const float gate_m = m2 > 1e-30f ? 1.0f : 0.0f;
        const float dot_mc = mx * cndx + my * cndy + mz * cndz;
        const float k_m = gate_m * minv * minv * minv * dot_mc;
        crx = minv * cndx - k_m * mx;
        cry = minv * cndy - k_m * my;
        crz = minv * cndz - k_m * mz;
        cbrg = ux * crx + uy * cry + uz * crz;
        cddot = 0.0f;
      }
      // r = d - 2 ddot n ; ddot = d.n
      cdx = cdx + crx; cdy = cdy + cry; cdz = cdz + crz;
      cddot = cddot - 2.0f * (nx * crx + ny * cry + nz * crz);
      cnx = cnx - 2.0f * ddot * crx;
      cny = cny - 2.0f * ddot * cry;
      cnz = cnz - 2.0f * ddot * crz;
      cdx = cdx + cddot * nx; cdy = cdy + cddot * ny; cdz = cdz + cddot * nz;
      cnx = cnx + cddot * dx; cny = cny + cddot * dy; cnz = cnz + cddot * dz;
    } else if (word & kLdeg) {
      // lambert, degenerate: l = n
      cnx = cndx; cny = cndy; cnz = cndz;
    } else {
      // lambert: l = lxr linv, linv = rsqrt(max(ln2, 1e-30)), lxr = n + u
      const float lxx = nx + ux, lxy = ny + uy, lxz = nz + uz;
      const float ln2 = lxx * lxx + lxy * lxy + lxz * lxz;
      const float linv = rsqrt_rn(fmaxf(ln2, 1e-30f));
      float clxx = linv * cndx, clxy = linv * cndy, clxz = linv * cndz;
      const float clinv = lxx * cndx + lxy * cndy + lxz * cndz;
      const float cw2 = -0.5f * linv * linv * linv * clinv;
      const float cln2 = ln2 > 1e-30f ? cw2 : 0.0f;
      clxx = clxx + 2.0f * cln2 * lxx;
      clxy = clxy + 2.0f * cln2 * lxy;
      clxz = clxz + 2.0f * cln2 * lxz;
      cnx = clxx; cny = clxy; cnz = clxz;
    }

    // ---- normal, hit point and t ----
    float cbcx = 0.0f, cbcy = 0.0f, cbcz = 0.0f;
    if (!ispl) {
      // n = sn sinv, sinv = rsqrt(max(sn.sn, 1e-30)) ; sn = h - bc
      const float gate_s = sn2 > 1e-30f ? 1.0f : 0.0f;
      const float dot_sc = snx * cnx + sny * cny + snz * cnz;
      const float k_s = gate_s * sinv * sinv * sinv * dot_sc;
      const float csnx = sinv * cnx - k_s * snx;
      const float csny = sinv * cny - k_s * sny;
      const float csnz = sinv * cnz - k_s * snz;
      chx = chx + csnx; chy = chy + csny; chz = chz + csnz;
      cbcx = -csnx; cbcy = -csny; cbcz = -csnz;
    }
    // h = o + t d
    cox = cox + chx; coy = coy + chy; coz = coz + chz;
    const float ctt = dx * chx + dy * chy + dz * chz;
    cdx = cdx + t * chx; cdy = cdy + t * chy; cdz = cdz + t * chz;
    if (ispl) {
      // t = -num / safe, num = pn.o + pd, safe = where(|pn.d| > 1e-12, pn.d, 1)
      const float cnum = -ctt / safe;
      const float cndd = nz_ok ? -(ctt * t) / safe : 0.0f;
      cox = cox + cnum * pnx; coy = coy + cnum * pny; coz = coz + cnum * pnz;
      cdx = cdx + cndd * pnx; cdy = cdy + cndd * pny; cdz = cdz + cndd * pnz;
      pg.key = 2 * win + 1;
      pg.g[0] = 0.0f; pg.g[1] = 0.0f; pg.g[2] = 0.0f; pg.g[3] = 0.0f;
      pg.g[4] = cbar; pg.g[5] = cbag; pg.g[6] = cbab; pg.g[7] = cbrf; pg.g[8] = cbrg;
    } else {
      // t = where(root, -bq - sq, -bq + sq), sq = sqrt(max(disc, 1e-12))
      float cbq = -ctt;
      const float csq = root ? -ctt : ctt;
      const float cdisc = disc > 1e-12f ? 0.5f * csq / sq : 0.0f;
      cbq = cbq + 2.0f * bq * cdisc;
      const float cc0 = -cdisc;
      // c0 = oc.oc - r^2 ; bq = oc.d ; oc = o - bc
      float cocx = 2.0f * cc0 * ocx, cocy = 2.0f * cc0 * ocy, cocz = 2.0f * cc0 * ocz;
      const float cbrad = -2.0f * q[3] * cc0;
      cocx = cocx + cbq * dx; cocy = cocy + cbq * dy; cocz = cocz + cbq * dz;
      cdx = cdx + cbq * ocx; cdy = cdy + cbq * ocy; cdz = cdz + cbq * ocz;
      cox = cox + cocx; coy = coy + cocy; coz = coz + cocz;
      cbcx = cbcx - cocx; cbcy = cbcy - cocy; cbcz = cbcz - cocz;
      pg.key = 2 * win;
      pg.g[0] = cbcx; pg.g[1] = cbcy; pg.g[2] = cbcz; pg.g[3] = cbrad;
      pg.g[4] = cbar; pg.g[5] = cbag; pg.g[6] = cbab; pg.g[7] = cbrf; pg.g[8] = cbrg;
    }
  }
  co[0] = cox; co[1] = coy; co[2] = coz;
  cd[0] = cdx; cd[1] = cdy; cd[2] = cdz;
  ct[0] = ctr; ct[1] = ctg; ct[2] = ctb;
  return pg;
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float* red, float v) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (unsigned stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + stride];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

}  // namespace
