// Per-ray forward path tracing, shared by the three forward kernels:
// render_kernel.cu (tables in shared memory, rows of 10 and 12 floats),
// blockwise_kernel.cu and wavefront_kernel.cu (tables in device memory,
// rows of 16 floats).  The TPU kernels they replace
// (pallas_render._make_kernel, pallas_blockwise._make_blockwise_kernel and
// pallas_wavefront._make_wf_kernel) trace the same function: the same scan
// order and tie rules, the same draws, the same bounce math
// (pallas_blockwise._bounce_once is "exactly the unrolled kernel's
// straight-line vector code", and the wavefront kernel calls it for one
// bounce per launch).  Here bounce_once is that function: trace_pixel
// loops it over the bounces of every sample of a pixel, and the wavefront
// kernel runs it once per launch on a ray of its state table (bounce 0),
// or closest_hit, the same scan split over a group of lanes, and then
// bounce_once's second half finish_bounce (later bounces; closest_hit's
// note).
//
// Contract (with render_tile_plain in rt_tpu_torch/ops/render.py):
//   * Sample s of a call draws its jitter at counters s*(2+4B)+1 and +2,
//     and bounce b its unit vector and coin at s*(2+4B)+2+4b+1 ... +4
//     (B = max_bounces).  The JAX kernels increment one counter per draw
//     and take every draw of every bounce, live or not; computing the
//     counter from (s, b) gives the same numbers, and a `break` cannot
//     shift the draws of a later sample.
//   * 1/width, 1/height and the 16-float camera vector are computed on the
//     host in float64 and rounded to float32, as in JAX.
//   * Ties: planes are scanned first with strict '<' (the earliest row
//     wins); a sphere wins an exact tie against a plane and strict '<'
//     decides among spheres; boxes are scanned last with strict '<'
//     (pallas_render.py:313-411, pallas_blockwise.py:380-467).  Rows are
//     scanned in index order, so the winner is the first row at the
//     smallest distance.
//   * A ray that dies leaves the loop (`break`).  The TPU kernels skip a
//     bounce only when a whole tile is dead; both are exact, because a dead
//     ray changes no carried value.  A metal that absorbs still moves the
//     ray to its hit point and new direction, as _bounce_once does (only
//     the wavefront state keeps them, and nothing reads a dead ray's).
//
// The record form of bounce_once (template argument kRec, used by
// record_pixel for the two record kernels) also returns the bounce's
// replay record, as the JAX record kernels write it
// (pallas_render.py:532-549; pallas_blockwise.py:1034-1059): the winner's
// kind in the records' numbering (0 miss, 1 sphere, 2 plane, 3 box: not
// the Kind enum's), its index within its class, the bits word (1 near root
// of the winning sphere, 2 dielectric reflect, 4 lambert degenerate, 8 live
// and missed, 16 live in, 32 alive out), the normalized unit vector and the
// coin.  The JAX kernels compute the reflect and degeneracy decisions
// densely, on every lane whatever its class, a missed lane included (with
// the empty winner: normal from a zero centre, reflectivity 1), so the
// record form computes both on every live ray.  Where the two JAX kernels
// differ, on bits that the replay never reads, each record form follows
// its own: the unrolled kernel (kRecUnrolled) computes the reflect bit only
// when its tables hold a dielectric (its class-presence specialization,
// pallas_render.py:201-205) and keeps the root bit of the last sphere that
// led the scan (a box may beat it later); the blockwise kernel
// (kRecBlockwise) computes the reflect bit always and recomputes the root
// bit from the winner's sphere row, an all-zero row unless a sphere won.
// The existing kernels instantiate kRecNone, for which none of this is
// compiled.

#pragma once

#include "common.cuh"

namespace {

enum Kind { kNone = 0, kPlane = 1, kSphere = 2, kBox = 3 };

// The record forms of bounce_once (see the note above).
enum RecordForm { kRecNone = 0, kRecUnrolled = 1, kRecBlockwise = 2 };

// One bounce's replay record.
struct Record {
  int32_t kind, idx, bits;
  float ux, uy, uz, coin;
};

// Where a record kernel writes: rad (N, 3), the per-bounce records (B, N)
// each, the jitter (2, N).
struct RecordPtrs {
  float* rad;
  int32_t *kind, *idx, *bits;
  float *urx, *ury, *urz, *coin, *jitter;
};

__device__ __forceinline__ float sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Row-major primitive tables: spheres and planes hold
// [cx|nx, cy|ny, cz|nz, r|d, alb r, g, b, refl, rough, cls] in their first
// 10 columns, boxes [cx, cy, cz, ex, ey, ez, alb r, g, b, refl, rough, cls]
// in their first 12; kPrimStride and kBoxStride are the row lengths.
struct Tables {
  const float* spheres; int n_spheres;
  const float* planes; int n_planes;
  const float* boxes; int n_boxes;
};

// One ray's carried values between bounces.
struct Ray {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb;
};

// The camera ray through (px + jx, py + jy) of the 16-float camera vector.
__device__ __forceinline__ Ray camera_ray(const float* __restrict__ cam, float px, float py,
                                          float jx, float jy, float inv_w, float inv_h) {
  const float ndc_x = 2.0f * (px + jx) * inv_w - 1.0f;
  const float ndc_y = 1.0f - 2.0f * (py + jy) * inv_h;
  const float dvx = ndc_x * cam[12] * cam[13];
  const float dvy = ndc_y * cam[12];
  const float dwx = cam[3] * dvx + cam[4] * dvy - cam[5];
  const float dwy = cam[6] * dvx + cam[7] * dvy - cam[8];
  const float dwz = cam[9] * dvx + cam[10] * dvy - cam[11];
  const float near = cam[14];
  const float dinv = rsqrt_rn(dwx * dwx + dwy * dwy + dwz * dwz);
  return Ray{cam[0] + dwx * near, cam[1] + dwy * near, cam[2] + dwz * near,
             dwx * dinv, dwy * dinv, dwz * dinv, 1.0f, 1.0f, 1.0f};
}

// The draws of one bounce at counters c+1 .. c+4: the unit vector (mapped
// to [-1, 1) first under rng_sphere) normalized, and the coin.
__device__ __forceinline__ void unit_draws(uint32_t pix, uint32_t seed, uint32_t c,
                                           int rng_sphere, float& ux, float& uy, float& uz,
                                           float& coin) {
  ux = hash_u01(pix, seed, c + 1u);
  uy = hash_u01(pix, seed, c + 2u);
  uz = hash_u01(pix, seed, c + 3u);
  coin = hash_u01(pix, seed, c + 4u);
  if (rng_sphere) {
    ux = 2.0f * ux - 1.0f; uy = 2.0f * uy - 1.0f; uz = 2.0f * uz - 1.0f;
  }
  const float uinv = rsqrt_rn(fmaxf(ux * ux + uy * uy + uz * uz, 1e-30f));
  ux = ux * uinv; uy = uy * uinv; uz = uz * uinv;
}

// The record form's decision bits and the rest of its record, for a live
// ray at pre-bounce origin o and direction d whose winner (kind, win, the
// scan's root flag) has normal n and reflectivity brf.  The lambert and
// Fresnel expressions are bounce_once's, operation for operation.
template <int kRec>
__device__ __forceinline__ void fill_record(Record* rec, int kind, int win, bool root, float ox,
                                            float oy, float oz, float dx, float dy, float dz,
                                            float nx, float ny, float nz, float brf, float ux,
                                            float uy, float uz, float coin, bool has_die,
                                            bool alive) {
  const float lx = nx + ux, ly = ny + uy, lz = nz + uz;
  const bool ldeg = lx * lx + ly * ly + lz * lz < 1e-16f;
  bool refl = false;
  if (has_die) {
    const float dd = dx * nx + dy * ny + dz * nz;
    const bool inside = dd > 0.0f;
    const float sgn = inside ? -1.0f : 1.0f;
    const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
    const float eta = inside ? brf : 1.0f / fmaxf(brf, 1e-12f);
    const float cosine = inside ? brf * dd : -dd;
    const float cos_i = -(dx * onx + dy * ony + dz * onz);
    const float sin2 = eta * eta * (1.0f - cos_i * cos_i);
    float r0s = (1.0f - brf) / (1.0f + brf);
    r0s = r0s * r0s;
    const float omc = 1.0f - cosine;
    const float omc2 = omc * omc;
    const float prob = sin2 > 1.0f ? 1.0f : r0s + (1.0f - r0s) * omc2 * omc2 * omc;
    refl = coin < prob;
  }
  if constexpr (kRec == kRecBlockwise) {
    if (kind != kSphere) {
      // the root of an all-zero sphere row
      const float zb = ox * dx + oy * dy + oz * dz;
      const float zdisc = zb * zb - (ox * ox + oy * oy + oz * oz);
      root = -zb - sqrtf(fmaxf(zdisc, 0.0f)) >= kMinHit;
    }
  }
  rec->kind = kind == kSphere ? 1 : (kind == kPlane ? 2 : (kind == kBox ? 3 : 0));
  rec->idx = win;
  rec->bits = (root ? 1 : 0) | (refl ? 2 : 0) | (ldeg ? 4 : 0) | (kind == kNone ? 8 : 0) | 16 |
              (alive ? 32 : 0);
  rec->ux = ux; rec->uy = uy; rec->uz = uz; rec->coin = coin;
}

// The closest hit of ray (o, d) over rows first, first + step, first +
// 2 step, ... of the plane, sphere and box tables, in that order, with the
// tie rules of the note above: `best` (kBig when no row is hit), the
// winner's kind and row and, for the record forms, the near-root flag of
// the sphere that last led.  The wavefront kernel's later bounces split
// one ray's rows over a group of `step` lanes (wavefront_kernel.cu) and
// merge the lanes' winners with merge_hit, which reproduces the full
// scan's winner exactly.  Its loops repeat the per-row expressions of
// bounce_once's scan, row for row, so that every lane computes each row's
// t as the serial scan does.  bounce_once keeps its own loops: compiled
// through closest_hit (first 0, step 1) or through shared per-row
// helpers, nvcc scheduled the serving kernels differently, the blockwise
// kernel 4.5% (helpers: 2.2%) slower at the config-4 train step's launch
// (chip_ab.py; PERF.md); with its own loops every kernel that runs
// bounce_once compiles to the code it had before the split existed.
template <int kPrimStride, int kBoxStride, int kRec = kRecNone>
__device__ __forceinline__ void closest_hit(const Tables& T, float ox, float oy, float oz,
                                            float dx, float dy, float dz, int first, int step,
                                            float& best, int& kind, int& win, bool& root) {
  best = kBig;
  kind = kNone;
  win = 0;
  root = false;
  for (int p = first; p < T.n_planes; p += step) {
    const float* q = T.planes + p * kPrimStride;
    const float nd = q[0] * dx + q[1] * dy + q[2] * dz;
    const float no = q[0] * ox + q[1] * oy + q[2] * oz + q[3];
    if (fabsf(nd) > 1e-12f) {
      const float t = -no / nd;
      if (t >= kMinHit && t < best) { best = t; kind = kPlane; win = p; }
    }
  }
  for (int i = first; i < T.n_spheres; i += step) {
    const float* q = T.spheres + i * kPrimStride;
    const float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
    const float bq = ocx * dx + ocy * dy + ocz * dz;
    const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
    const float disc = bq * bq - c0;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -bq - sq;
    const float t1 = -bq + sq;
    const float t = t0 >= kMinHit ? t0 : t1;
    if (disc >= 0.0f && t >= kMinHit && (t < best || (t == best && kind == kPlane))) {
      best = t; kind = kSphere; win = i;
      if constexpr (kRec != kRecNone) root = t0 >= kMinHit;
    }
  }
  if (T.n_boxes > 0) {
    const float ivx = 1.0f / (fabsf(dx) > 1e-12f ? dx : 1e-12f);
    const float ivy = 1.0f / (fabsf(dy) > 1e-12f ? dy : 1e-12f);
    const float ivz = 1.0f / (fabsf(dz) > 1e-12f ? dz : 1e-12f);
    for (int i = first; i < T.n_boxes; i += step) {
      const float* q = T.boxes + i * kBoxStride;
      const float tax = (q[0] - q[3] - ox) * ivx, tbx = (q[0] + q[3] - ox) * ivx;
      const float tay = (q[1] - q[4] - oy) * ivy, tby = (q[1] + q[4] - oy) * ivy;
      const float taz = (q[2] - q[5] - oz) * ivz, tbz = (q[2] + q[5] - oz) * ivz;
      const float tmn = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
      const float tmx = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
      const float t = tmn >= kMinHit ? tmn : tmx;
      if (tmx >= tmn && t >= kMinHit && t < best) { best = t; kind = kBox; win = i; }
    }
  }
}

// The rest of one bounce of one live ray (pallas_blockwise._bounce_once
// after its scan), given the scan's result over every row: on a miss the
// sky is added to rad and the path ends; on a hit the ray moves to the hit
// point and its scattered direction, and its throughput takes the winner's
// albedo times reflectivity unless a metal absorbed it (then the path ends
// with the throughput unchanged).  The draws are at counters c+1 .. c+4 (c
// = sample base + 2 + 4b).  Returns whether the ray lives on; `word`
// receives the winner word, and the record forms (kRec != kRecNone) fill
// `rec`, with the reflect bit only where `has_die`.
template <int kPrimStride, int kBoxStride, int kRec = kRecNone>
__device__ __forceinline__ bool finish_bounce(const Tables& T, uint32_t pix, uint32_t seed,
                                              uint32_t c, int rng_sphere, Ray& r, float rad[3],
                                              int32_t& word, float best, int kind, int win,
                                              bool root, Record* rec = nullptr,
                                              bool has_die = true) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  if (!(best < 1e37f)) {  // miss: sky (mg_ray_tracer.cpp:164), the path ends
    const float ts = 0.5f * (dy + 1.0f);
    rad[0] = rad[0] + r.tr * (1.0f - 0.5f * ts);
    rad[1] = rad[1] + r.tg * (1.0f - 0.3f * ts);
    rad[2] = rad[2] + r.tb;
    word = kWordMiss;
    if constexpr (kRec != kRecNone) {
      // the empty winner: the sphere normal of a zero centre at the
      // origin (t = 0), reflectivity 1
      float ux, uy, uz, coin;
      unit_draws(pix, seed, c, rng_sphere, ux, uy, uz, coin);
      const float hx = ox + 0.0f * dx, hy = oy + 0.0f * dy, hz = oz + 0.0f * dz;
      const float sinv = rsqrt_rn(fmaxf(hx * hx + hy * hy + hz * hz, 1e-30f));
      fill_record<kRec>(rec, kNone, 0, root, ox, oy, oz, dx, dy, dz, hx * sinv, hy * sinv,
                        hz * sinv, 1.0f, ux, uy, uz, coin, has_die, false);
    }
    return false;
  }
  word = win | (kind == kPlane ? kWordPlane : 0) | (kind == kBox ? kWordBox : 0);

  // ---- hit point, normal, payload ----
  const float hx = ox + best * dx, hy = oy + best * dy, hz = oz + best * dz;
  float nx, ny, nz;
  const float* pay;  // albedo r, g, b, reflectivity, roughness, class
  if (kind == kPlane) {
    const float* q = T.planes + win * kPrimStride;
    nx = q[0]; ny = q[1]; nz = q[2];
    pay = q + 4;
  } else if (kind == kSphere) {
    const float* q = T.spheres + win * kPrimStride;
    const float snx = hx - q[0], sny = hy - q[1], snz = hz - q[2];
    const float sinv = rsqrt_rn(fmaxf(snx * snx + sny * sny + snz * snz, 1e-30f));
    nx = snx * sinv; ny = sny * sinv; nz = snz * sinv;
    pay = q + 4;
  } else {
    // outward slab-face normal: sign of the dominant component of the
    // extent-scaled local hit position; x wins a tie, then y
    const float* q = T.boxes + win * kBoxStride;
    const float blx = (hx - q[0]) / fmaxf(q[3], 1e-12f);
    const float bly = (hy - q[1]) / fmaxf(q[4], 1e-12f);
    const float blz = (hz - q[2]) / fmaxf(q[5], 1e-12f);
    const float ax = fabsf(blx), ay = fabsf(bly), az = fabsf(blz);
    const bool is_x = ax >= ay && ax >= az;
    const bool is_y = !is_x && ay >= az;
    const bool is_z = !(is_x || is_y);
    nx = is_x ? sign(blx) : 0.0f;
    ny = is_y ? sign(bly) : 0.0f;
    nz = is_z ? sign(blz) : 0.0f;
    pay = q + 6;
  }
  const float bar = pay[0], bag = pay[1], bab = pay[2], brf = pay[3], brg = pay[4];
  const float cls = pay[5];

  // ---- scatter (draws at counters c+1 .. c+4) ----
  float ux, uy, uz, coin;
  unit_draws(pix, seed, c, rng_sphere, ux, uy, uz, coin);

  float ndx, ndy, ndz;
  bool alive = true;
  if (cls == 1.0f) {
    // metal (mg_ray_tracer.cpp:125-140)
    const float dd = dx * nx + dy * ny + dz * nz;
    const float mx = dx - 2.0f * dd * nx + brg * ux;
    const float my = dy - 2.0f * dd * ny + brg * uy;
    const float mz = dz - 2.0f * dd * nz + brg * uz;
    alive = !((mx * nx + my * ny + mz * nz) <= 0.0f);
    const float minv = rsqrt_rn(fmaxf(mx * mx + my * my + mz * mz, 1e-30f));
    ndx = mx * minv; ndy = my * minv; ndz = mz * minv;
  } else if (cls == 2.0f) {
    // dielectric (sm_ray_tracer.cpp:181-219)
    const float dd = dx * nx + dy * ny + dz * nz;
    const float rx = dx - 2.0f * dd * nx;
    const float ry = dy - 2.0f * dd * ny;
    const float rz = dz - 2.0f * dd * nz;
    const bool inside = dd > 0.0f;
    const float sgn = inside ? -1.0f : 1.0f;
    const float onx = sgn * nx, ony = sgn * ny, onz = sgn * nz;
    const float eta = inside ? brf : 1.0f / fmaxf(brf, 1e-12f);
    const float cosine = inside ? brf * dd : -dd;
    const float cos_i = -(dx * onx + dy * ony + dz * onz);
    const float sin2 = eta * eta * (1.0f - cos_i * cos_i);
    const float cos_t = sqrtf(fmaxf(1.0f - sin2, 0.0f));
    const float k = eta * cos_i - cos_t;
    float r0s = (1.0f - brf) / (1.0f + brf);
    r0s = r0s * r0s;
    const float omc = 1.0f - cosine;
    const float omc2 = omc * omc;
    const float prob = sin2 > 1.0f ? 1.0f : r0s + (1.0f - r0s) * omc2 * omc2 * omc;
    float gx, gy, gz;
    if (coin < prob) {
      gx = rx; gy = ry; gz = rz;
    } else {
      gx = eta * dx + k * onx; gy = eta * dy + k * ony; gz = eta * dz + k * onz;
    }
    const float ginv = rsqrt_rn(fmaxf(gx * gx + gy * gy + gz * gz, 1e-30f));
    ndx = gx * ginv; ndy = gy * ginv; ndz = gz * ginv;
  } else {
    // lambert (mg_ray_tracer.cpp:109-123), degenerate -> normal
    const float lx = nx + ux, ly = ny + uy, lz = nz + uz;
    const float ln2 = lx * lx + ly * ly + lz * lz;
    if (ln2 < 1e-16f) {
      ndx = nx; ndy = ny; ndz = nz;
    } else {
      const float linv = rsqrt_rn(ln2);
      ndx = lx * linv; ndy = ly * linv; ndz = lz * linv;
    }
  }

  if constexpr (kRec != kRecNone) {
    fill_record<kRec>(rec, kind, win, root, ox, oy, oz, dx, dy, dz, nx, ny, nz, brf, ux, uy, uz,
                      coin, has_die, alive);
  }
  if (alive) {
    r.tr = r.tr * (bar * brf);
    r.tg = r.tg * (bag * brf);
    r.tb = r.tb * (bab * brf);
  }
  r.ox = hx; r.oy = hy; r.oz = hz;
  r.dx = ndx; r.dy = ndy; r.dz = ndz;
  return alive;
}

// One bounce of one live ray (pallas_blockwise._bounce_once): the closest
// hit over every row in index order (the serial scan: closest_hit's rule
// with first 0 and step 1, written out; see its note), then
// finish_bounce.
template <int kPrimStride, int kBoxStride, int kRec = kRecNone>
__device__ __forceinline__ bool bounce_once(const Tables& T, uint32_t pix, uint32_t seed,
                                            uint32_t c, int rng_sphere, Ray& r, float rad[3],
                                            int32_t& word, Record* rec = nullptr,
                                            bool has_die = true) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  // ---- closest hit ----
  float best = kBig;
  int kind = kNone, win = 0;
  bool root = false;  // record forms: the near-root flag of the sphere that last led the scan
  for (int p = 0; p < T.n_planes; ++p) {
    const float* q = T.planes + p * kPrimStride;
    const float nd = q[0] * dx + q[1] * dy + q[2] * dz;
    const float no = q[0] * ox + q[1] * oy + q[2] * oz + q[3];
    if (fabsf(nd) > 1e-12f) {
      const float t = -no / nd;
      if (t >= kMinHit && t < best) { best = t; kind = kPlane; win = p; }
    }
  }
  for (int i = 0; i < T.n_spheres; ++i) {
    const float* q = T.spheres + i * kPrimStride;
    const float ocx = ox - q[0], ocy = oy - q[1], ocz = oz - q[2];
    const float bq = ocx * dx + ocy * dy + ocz * dz;
    const float c0 = ocx * ocx + ocy * ocy + ocz * ocz - q[3] * q[3];
    const float disc = bq * bq - c0;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = -bq - sq;
    const float t1 = -bq + sq;
    const float t = t0 >= kMinHit ? t0 : t1;
    if (disc >= 0.0f && t >= kMinHit && (t < best || (t == best && kind == kPlane))) {
      best = t; kind = kSphere; win = i;
      if constexpr (kRec != kRecNone) root = t0 >= kMinHit;
    }
  }
  if (T.n_boxes > 0) {
    const float ivx = 1.0f / (fabsf(dx) > 1e-12f ? dx : 1e-12f);
    const float ivy = 1.0f / (fabsf(dy) > 1e-12f ? dy : 1e-12f);
    const float ivz = 1.0f / (fabsf(dz) > 1e-12f ? dz : 1e-12f);
    for (int i = 0; i < T.n_boxes; ++i) {
      const float* q = T.boxes + i * kBoxStride;
      const float tax = (q[0] - q[3] - ox) * ivx, tbx = (q[0] + q[3] - ox) * ivx;
      const float tay = (q[1] - q[4] - oy) * ivy, tby = (q[1] + q[4] - oy) * ivy;
      const float taz = (q[2] - q[5] - oz) * ivz, tbz = (q[2] + q[5] - oz) * ivz;
      const float tmn = fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz));
      const float tmx = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
      const float t = tmn >= kMinHit ? tmn : tmx;
      if (tmx >= tmn && t >= kMinHit && t < best) { best = t; kind = kBox; win = i; }
    }
  }

  return finish_bounce<kPrimStride, kBoxStride, kRec>(T, pix, seed, c, rng_sphere, r, rad, word,
                                                      best, kind, win, root, rec, has_die);
}

// Sum of pre-gamma radiance over `spp` samples of pixel (px, py), flat
// index `pix`, into acc[0..2].  The words form (kWords, with spp = 1: the
// blockwise training step's forward launches) also writes the sample's
// winner word of bounce b at words[b * n + pix], and the miss word for
// every bounce after the path has ended; the blockwise gradient kernel
// replays these winners instead of scanning again.
template <int kPrimStride, int kBoxStride, bool kWords = false>
__device__ __forceinline__ void trace_pixel(
    const Tables& T, const float* __restrict__ cam, uint32_t pix, float px, float py,
    uint32_t seed, float inv_w, float inv_h, int spp, int max_bounces, int center_sample,
    int rng_sphere, float acc[3], int32_t* __restrict__ words = nullptr, int n = 0) {
  const uint32_t per_sample = 2u + 4u * static_cast<uint32_t>(max_bounces);
  acc[0] = 0.0f;
  acc[1] = 0.0f;
  acc[2] = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t base = static_cast<uint32_t>(s) * per_sample;
    float jx = 0.5f, jy = 0.5f;  // sample 0 at the pixel centre (mg_ray_tracer.cpp:189)
    if (s != 0 || !center_sample) {
      jx = hash_u01(pix, seed, base + 1u);
      jy = hash_u01(pix, seed, base + 2u);
    }
    Ray r = camera_ray(cam, px, py, jx, jy, inv_w, inv_h);
    int32_t word;
    for (int b = 0; b < max_bounces; ++b) {
      const uint32_t c = base + 2u + 4u * static_cast<uint32_t>(b);
      const bool alive = bounce_once<kPrimStride, kBoxStride>(T, pix, seed, c, rng_sphere, r,
                                                              acc, word);
      if constexpr (kWords) words[static_cast<int64_t>(b) * n + pix] = word;
      if (!alive) {
        if constexpr (kWords) {
          for (int e = b + 1; e < max_bounces; ++e)
            words[static_cast<int64_t>(e) * n + pix] = kWordMiss;
        }
        break;
      }
    }
  }
}

// One sample of pixel (px, py), flat index `pix` of `n`, with its replay
// records (the record kernels, rows 2 and 6): the sample's counters are
// trace_pixel's with spp = 1, its jitter is written even at the pixel
// centre (0.5), every bounce writes its draws, and once the path has ended
// a bounce writes kind, idx and bits 0.
template <int kPrimStride, int kBoxStride, int kRec>
__device__ __forceinline__ void record_pixel(const Tables& T, const float* __restrict__ cam,
                                             uint32_t pix, int n, float px, float py,
                                             uint32_t seed, float inv_w, float inv_h,
                                             int max_bounces, int center_sample, int rng_sphere,
                                             bool has_die, const RecordPtrs& P) {
  float jx = 0.5f, jy = 0.5f;
  if (!center_sample) {
    jx = hash_u01(pix, seed, 1u);
    jy = hash_u01(pix, seed, 2u);
  }
  P.jitter[pix] = jx;
  P.jitter[n + pix] = jy;
  Ray r = camera_ray(cam, px, py, jx, jy, inv_w, inv_h);
  float rad[3] = {0.0f, 0.0f, 0.0f};
  bool alive = true;
  int32_t word;
  for (int b = 0; b < max_bounces; ++b) {
    const uint32_t c = 2u + 4u * static_cast<uint32_t>(b);
    Record rec{0, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
    if (alive) {
      alive = bounce_once<kPrimStride, kBoxStride, kRec>(T, pix, seed, c, rng_sphere, r, rad,
                                                         word, &rec, has_die);
    } else {
      unit_draws(pix, seed, c, rng_sphere, rec.ux, rec.uy, rec.uz, rec.coin);
    }
    const int64_t o = static_cast<int64_t>(b) * n + pix;
    P.kind[o] = rec.kind;
    P.idx[o] = rec.idx;
    P.bits[o] = rec.bits;
    P.urx[o] = rec.ux;
    P.ury[o] = rec.uy;
    P.urz[o] = rec.uz;
    P.coin[o] = rec.coin;
  }
  float* out = P.rad + static_cast<int64_t>(pix) * 3;
  out[0] = rad[0];
  out[1] = rad[1];
  out[2] = rad[2];
}

}  // namespace
