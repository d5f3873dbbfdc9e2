// Per-pixel forward path tracing, shared by the two forward kernels:
// render_kernel.cu (tables in shared memory, rows of 10 and 12 floats) and
// blockwise_kernel.cu (tables in device memory, rows of 16 floats).  Both
// TPU kernels they replace (pallas_render._make_kernel and
// pallas_blockwise._make_blockwise_kernel) trace the same function: the
// same scan order and tie rules, the same draws, the same bounce math
// (pallas_blockwise._bounce_once is "exactly the unrolled kernel's
// straight-line vector code").
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
//     ray changes no carried value.

#pragma once

#include "common.cuh"

namespace {

enum Kind { kNone = 0, kPlane = 1, kSphere = 2, kBox = 3 };

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

// Sum of pre-gamma radiance over `spp` samples of pixel (px, py), flat
// index `pix`, into acc[0..2].
template <int kPrimStride, int kBoxStride>
__device__ __forceinline__ void trace_pixel(
    const Tables& T, const float* __restrict__ cam, uint32_t pix, float px, float py,
    uint32_t seed, float inv_w, float inv_h, int spp, int max_bounces, int center_sample,
    int rng_sphere, float acc[3]) {
  const float cpx = cam[0], cpy = cam[1], cpz = cam[2];
  const float r0 = cam[3], r1 = cam[4], r2 = cam[5];
  const float r3 = cam[6], r4 = cam[7], r5 = cam[8];
  const float r6 = cam[9], r7 = cam[10], r8 = cam[11];
  const float tan_half = cam[12], aspect = cam[13], near = cam[14];

  const uint32_t per_sample = 2u + 4u * static_cast<uint32_t>(max_bounces);
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;

  for (int s = 0; s < spp; ++s) {
    const uint32_t base = static_cast<uint32_t>(s) * per_sample;
    float jx = 0.5f, jy = 0.5f;  // sample 0 at the pixel centre (mg_ray_tracer.cpp:189)
    if (s != 0 || !center_sample) {
      jx = hash_u01(pix, seed, base + 1u);
      jy = hash_u01(pix, seed, base + 2u);
    }
    const float ndc_x = 2.0f * (px + jx) * inv_w - 1.0f;
    const float ndc_y = 1.0f - 2.0f * (py + jy) * inv_h;
    const float dvx = ndc_x * tan_half * aspect;
    const float dvy = ndc_y * tan_half;
    const float dwx = r0 * dvx + r1 * dvy - r2;
    const float dwy = r3 * dvx + r4 * dvy - r5;
    const float dwz = r6 * dvx + r7 * dvy - r8;
    float ox = cpx + dwx * near, oy = cpy + dwy * near, oz = cpz + dwz * near;
    const float dinv = rsqrt_rn(dwx * dwx + dwy * dwy + dwz * dwz);
    float dx = dwx * dinv, dy = dwy * dinv, dz = dwz * dinv;
    float tr = 1.0f, tg = 1.0f, tb = 1.0f;

    for (int b = 0; b < max_bounces; ++b) {
      // ---- closest hit ----
      float best = kBig;
      int kind = kNone, win = 0;
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

      if (!(best < 1e37f)) {  // miss: sky (mg_ray_tracer.cpp:164), the path ends
        const float ts = 0.5f * (dy + 1.0f);
        acc0 = acc0 + tr * (1.0f - 0.5f * ts);
        acc1 = acc1 + tg * (1.0f - 0.3f * ts);
        acc2 = acc2 + tb;
        break;
      }

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

      // ---- scatter (draws at counters base+2+4b+1 .. +4) ----
      const uint32_t c = base + 2u + 4u * static_cast<uint32_t>(b);
      float ux = hash_u01(pix, seed, c + 1u);
      float uy = hash_u01(pix, seed, c + 2u);
      float uz = hash_u01(pix, seed, c + 3u);
      const float coin = hash_u01(pix, seed, c + 4u);
      if (rng_sphere) {
        ux = 2.0f * ux - 1.0f; uy = 2.0f * uy - 1.0f; uz = 2.0f * uz - 1.0f;
      }
      const float uinv = rsqrt_rn(fmaxf(ux * ux + uy * uy + uz * uz, 1e-30f));
      ux = ux * uinv; uy = uy * uinv; uz = uz * uinv;

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

      if (!alive) break;  // metal absorbed: throughput unchanged, path ends
      tr = tr * (bar * brf);
      tg = tg * (bag * brf);
      tb = tb * (bab * brf);
      ox = hx; oy = hy; oz = hz;
      dx = ndx; dy = ndy; dz = ndz;
    }
  }
  acc[0] = acc0;
  acc[1] = acc1;
  acc[2] = acc2;
}

}  // namespace
