"""Forward megakernel: a path-traced frame in one CUDA launch per sample
chunk (port of ``rt_tpu.ops.pallas_render``).

The kernel (``csrc/render_kernel.cu``) runs raygen → bounce loop → sample
accumulation for one pixel per thread and writes one float3 per pixel; its
source comment says what bounds it on the card and how the design follows.
Beside it:

* :func:`render_tile_plain` — the same function in plain PyTorch, written
  as the JAX kernel body is (dense over pixels, masked selects, one
  primitive at a time).  It is the CPU path and the reference the kernel
  is compared with on the card.
* :func:`render_tile` — the kernel wrapper.  A CPU tensor goes to the
  plain version; a CUDA tensor goes to the kernel, and nothing else.
  ``render_tile.launches`` counts kernel launches.
* :func:`render_forward` / :func:`make_render_step` — the entry points,
  counterparts of ``render_forward_pallas`` and ``make_render_step``.
  High sample counts are chunked into calls of ``_SPP_CHUNK`` samples with
  the LCG seed chain of :func:`_chunk_seeds`; the chunk sums are added in
  chunk order, scaled by float32(1/spp) and gamma-corrected (sqrt).

Only the portable counter-hash RNG (``rng_impl="hash"`` in the JAX package)
exists here: the TPU's hardware generator has no counterpart.  With it, the
port draws the same random numbers as ``render_forward_pallas(...,
rng_impl="hash")``, so both render the same image up to float rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..materials import personality_classes
from ..profiling import span

__all__ = ["MAX_UNROLL_PRIMS", "supported", "hash_u01", "render_tile",
           "render_tile_plain", "render_forward", "make_render_step"]

_BIG = 3.0e38
_MIN_HIT = 0.001
# the JAX kernel's unroll cap (compile time); here it bounds the tables
# that one block holds in shared memory (640 x 12 float32 = 30 KB)
MAX_UNROLL_PRIMS = 640
# samples per kernel call.  The chunking fixes the RNG stream (each chunk
# has its own seed and restarts its counter), so this is the JAX entry
# points' default ``spp_unroll`` and must stay equal to it for the port to
# render the same image.
_SPP_CHUNK = 4


def supported(scene, include_boxes: bool = False) -> bool:
    """Whether the megakernel takes this scene (the JAX kernel's cap).
    Without ``include_boxes`` boxes are never tested — the reference's box
    stub (mg_ray_tracer.cpp:89-93)."""
    n = scene.spheres.count + scene.planes.count
    if include_boxes:
        n += scene.boxes.count
    return n <= MAX_UNROLL_PRIMS


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _flatten_primitives(scene, personality: str):
    """Per-primitive columns with the material payload baked in, as
    (10, count) float32 arrays for spheres and planes.

    Rows: [cx/nx, cy/ny, cz/nz, r/d, alb_r, alb_g, alb_b, refl, rough, cls].
    Only the first ``count`` entries are returned (padding is dropped)."""
    classes = _np(personality_classes(personality))
    mat_t = _np(scene.materials.type)
    mat_alb = _np(scene.materials.albedo)
    mat_refl = _np(scene.materials.reflectivity)
    mat_rough = _np(scene.materials.roughness)

    def build(geom_cols, mats, count):
        m = mats[:count]
        cols = np.zeros((10, count), np.float32)
        for i, g in enumerate(geom_cols):
            cols[i] = g[:count]
        if count:
            cols[4:7] = mat_alb[m][:, :3].T
            cols[7] = mat_refl[m]
            cols[8] = mat_rough[m]
            cols[9] = classes[mat_t[m]]
        return cols

    sc, sr = _np(scene.spheres.center), _np(scene.spheres.radius)
    s_cols = build([sc[:, 0], sc[:, 1], sc[:, 2], sr], _np(scene.spheres.material),
                   scene.spheres.count)
    pn, pd = _np(scene.planes.normal), _np(scene.planes.d)
    p_cols = build([pn[:, 0], pn[:, 1], pn[:, 2], pd], _np(scene.planes.material),
                   scene.planes.count)
    return s_cols, p_cols


def _flatten_boxes(scene, personality: str) -> np.ndarray:
    """Per-box columns for the ``--boxes`` extension, (12, count) float32.
    Rows: [cx, cy, cz, ex, ey, ez, alb_r, alb_g, alb_b, refl, rough, cls]."""
    classes = _np(personality_classes(personality))
    count = scene.boxes.count
    cols = np.zeros((12, count), np.float32)
    if count:
        m = _np(scene.boxes.material)[:count]
        cols[0:3] = _np(scene.boxes.center)[:count].T
        cols[3:6] = _np(scene.boxes.extents)[:count].T
        cols[6:9] = _np(scene.materials.albedo)[m][:, :3].T
        cols[9] = _np(scene.materials.reflectivity)[m]
        cols[10] = _np(scene.materials.roughness)[m]
        cols[11] = classes[_np(scene.materials.type)[m]]
    return cols


_M32 = 0xFFFFFFFF


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``u * c`` for int64 ``u`` in [0, 2**32) and a 32-bit
    constant ``c``, in two 16-bit halves so that no int64 product
    overflows."""
    lo = (u * (c & 0xFFFF)) & _M32
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_u01(pix: torch.Tensor, seed, ctr: int) -> torch.Tensor:
    """Counter-based U[0,1), bit for bit the JAX package's ``_hash_u01``:
    a lowbias32-style avalanche of ``pix*-1640531527 + seed*97929 +
    ctr*30103 + 1`` in wrapping 32-bit arithmetic, then the top 24 bits.

    ``pix`` and ``seed`` are int64 tensors (or ``seed`` an int); the 32-bit
    wraparound is done by masking the int64 values to their low 32 bits."""
    x = (pix * -1640531527 + seed * 97929 + (ctr * 30103 + 1)) & _M32
    u = x ^ (x >> 16)
    u = _mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = _mul32(u, 0x846CA68B)
    u = u ^ (u >> 16)
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _chunk_seeds(seed: int, n_chunks: int, frames: int = 1) -> np.ndarray:
    """Per-(sample-chunk, frame) seeds, (n_chunks, frames) int32.  Column f
    is the LCG chain of ``seed + f``, so frame 0 of a batched step
    reproduces the unbatched chain exactly."""
    cols = []
    for f in range(frames):
        chunk_seed = seed + f
        col = []
        for _ in range(n_chunks):
            col.append(chunk_seed)
            chunk_seed = int((chunk_seed * 1103515245 + 12345) % (2**31 - 1))
        cols.append(col)
    return np.asarray(cols, np.int32).T


def _inv_size(width: int, height: int) -> tuple[float, float]:
    """1/width and 1/height in float64, rounded to float32 (as JAX's
    ``f32(1.0 / width)``)."""
    return float(np.float32(1.0 / width)), float(np.float32(1.0 / height))


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    # 1/sqrt, as the kernel computes it (CUDA's rsqrtf and torch.rsqrt on
    # the card are not correctly rounded)
    return 1.0 / torch.sqrt(x)


# the winner word of a bounce (trace.cuh kWord*): the winner's row, bit 24
# for a plane, bit 26 for a box, or bit 25 alone on a miss
WORD_ROW, WORD_PLANE, WORD_MISS, WORD_BOX = (1 << 24) - 1, 1 << 24, 1 << 25, 1 << 26


def _bounce_plain(rows, o3, d3, thr3, live, u3, coin, rng_sphere, record=False, replay=None):
    """One bounce of every ray, dense over rays with masked selects
    (trace.cuh bounce_once; pallas_blockwise._bounce_once): the closest hit
    over ``rows`` = (plane, sphere, box) rows as lists of Python floats,
    the sky on a miss, the scatter.  ``live`` is the float live flag and
    ``u3``, ``coin`` the bounce's raw draws.

    Returns ``(radiance, o', d', thr', live', record)``: the bounce's sky
    radiance (zero unless a live ray missed), the carried values (a ray
    that was not live keeps them), the new live flag, and the record:
    with ``record`` the winner word (int64; a miss, or a ray that was not
    live, has ``WORD_MISS``); with ``replay`` the replay record
    (:func:`_replay_record`) of the record kernel whose conventions it
    follows, "unrolled" or "blockwise"; else None."""
    p_rows, s_rows, b_rows = rows
    ox, oy, oz = o3
    dx, dy, dz = d3
    tr, tg, tb = thr3
    ux, uy, uz = u3
    f32 = torch.float32
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
    lv = live > 0.0

    best_t = torch.full_like(ox, _BIG)
    bcx = bcy = bcz = zero
    bpnx = bpny = bpnz = zero
    bar = bag = bab = zero
    brf, brg, bcl, bpl = one, zero, zero, zero
    bbxf = zero
    bbcx = bbcy = bbcz = zero
    bbex = bbey = bbez = one
    track = record or replay is not None
    win = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device) if track else None
    root = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device) if replay else None

    for i, (pnx, pny, pnz, pdd, ar, ag, ab, rf, rg, cl) in enumerate(p_rows):
        nd = pnx * dx + pny * dy + pnz * dz
        no = pnx * ox + pny * oy + pnz * oz + pdd
        nz_ok = nd.abs() > 1e-12
        t = -no / torch.where(nz_ok, nd, 1.0)
        ok = nz_ok & (t >= _MIN_HIT) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        bpnx, bpny, bpnz = (torch.where(ok, v, o) for v, o in
                            ((pnx, bpnx), (pny, bpny), (pnz, bpnz)))
        bar, bag, bab, brf, brg, bcl = (torch.where(ok, v, o) for v, o in
                                        ((ar, bar), (ag, bag), (ab, bab),
                                         (rf, brf), (rg, brg), (cl, bcl)))
        bpl = torch.where(ok, 1.0, bpl)
        if track:
            win = torch.where(ok, i | WORD_PLANE, win)

    for i, (cx, cy, cz, rad, ar, ag, ab, rf, rg, cl) in enumerate(s_rows):
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        bq = ocx * dx + ocy * dy + ocz * dz
        c0 = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = bq * bq - c0
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t0 = -bq - sq
        t1 = -bq + sq
        t = torch.where(t0 >= _MIN_HIT, t0, t1)
        ok = (disc >= 0.0) & (t >= _MIN_HIT) & (
            (t < best_t) | ((t == best_t) & (bpl > 0.0)))
        best_t = torch.where(ok, t, best_t)
        bcx, bcy, bcz = (torch.where(ok, v, o) for v, o in
                         ((cx, bcx), (cy, bcy), (cz, bcz)))
        bar, bag, bab, brf, brg, bcl = (torch.where(ok, v, o) for v, o in
                                        ((ar, bar), (ag, bag), (ab, bab),
                                         (rf, brf), (rg, brg), (cl, bcl)))
        bpl = torch.where(ok, 0.0, bpl)
        if track:
            win = torch.where(ok, i, win)
        if replay:
            root = torch.where(ok, t0 >= _MIN_HIT, root)

    if b_rows:
        # slab test: boxes scanned last with strict '<', rays
        # starting inside hit the exit face
        invx = 1.0 / torch.where(dx.abs() > 1e-12, dx, 1e-12)
        invy = 1.0 / torch.where(dy.abs() > 1e-12, dy, 1e-12)
        invz = 1.0 / torch.where(dz.abs() > 1e-12, dz, 1e-12)
    for i, (cx, cy, cz, ex, ey, ez, ar, ag, ab, rf, rg, cl) in enumerate(b_rows):
        tax, tbx = (cx - ex - ox) * invx, (cx + ex - ox) * invx
        tay, tby = (cy - ey - oy) * invy, (cy + ey - oy) * invy
        taz, tbz = (cz - ez - oz) * invz, (cz + ez - oz) * invz
        tmn = torch.maximum(torch.maximum(torch.minimum(tax, tbx),
                                          torch.minimum(tay, tby)),
                            torch.minimum(taz, tbz))
        tmx = torch.minimum(torch.minimum(torch.maximum(tax, tbx),
                                          torch.maximum(tay, tby)),
                            torch.maximum(taz, tbz))
        tt = torch.where(tmn >= _MIN_HIT, tmn, tmx)
        ok = (tmx >= tmn) & (tt >= _MIN_HIT) & (tt < best_t)
        best_t = torch.where(ok, tt, best_t)
        bbcx, bbcy, bbcz = (torch.where(ok, v, o) for v, o in
                            ((cx, bbcx), (cy, bbcy), (cz, bbcz)))
        bbex, bbey, bbez = (torch.where(ok, max(v, 1e-12), o) for v, o in
                            ((ex, bbex), (ey, bbey), (ez, bbez)))
        bar, bag, bab, brf, brg, bcl = (torch.where(ok, v, o) for v, o in
                                        ((ar, bar), (ag, bag), (ab, bab),
                                         (rf, brf), (rg, brg), (cl, bcl)))
        bpl = torch.where(ok, 0.0, bpl)
        bbxf = torch.where(ok, 1.0, bbxf)
        if track:
            win = torch.where(ok, i | WORD_BOX, win)

    hit = best_t < 1e37

    # sky on miss (mg_ray_tracer.cpp:164)
    ts_ = 0.5 * (dy + 1.0)
    mf = (lv & ~hit).to(f32)
    rad = (mf * tr * (1.0 - 0.5 * ts_), mf * tg * (1.0 - 0.3 * ts_), mf * tb)

    live_h = lv & hit
    t_safe = torch.where(hit, best_t, 0.0)
    hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz

    snx, sny, snz = hx - bcx, hy - bcy, hz - bcz
    sinv = _rsqrt(torch.clamp_min(snx * snx + sny * sny + snz * snz, 1e-30))
    ispl = bpl > 0.0
    nx = torch.where(ispl, bpnx, snx * sinv)
    ny = torch.where(ispl, bpny, sny * sinv)
    nz = torch.where(ispl, bpnz, snz * sinv)
    if b_rows:
        # outward slab-face normal: sign of the dominant component
        # of the extent-scaled local hit position (x wins a tie)
        isbx = bbxf > 0.0
        blx, bly, blz = (hx - bbcx) / bbex, (hy - bbcy) / bbey, (hz - bbcz) / bbez
        axx, axy, axz = blx.abs(), bly.abs(), blz.abs()
        is_x = (axx >= axy) & (axx >= axz)
        is_y = ~is_x & (axy >= axz)
        is_z = ~(is_x | is_y)
        nx = torch.where(isbx, torch.where(is_x, torch.sign(blx), 0.0), nx)
        ny = torch.where(isbx, torch.where(is_y, torch.sign(bly), 0.0), ny)
        nz = torch.where(isbx, torch.where(is_z, torch.sign(blz), 0.0), nz)

    if rng_sphere:
        ux, uy, uz = 2.0 * ux - 1.0, 2.0 * uy - 1.0, 2.0 * uz - 1.0
    uinv = _rsqrt(torch.clamp_min(ux * ux + uy * uy + uz * uz, 1e-30))
    ux, uy, uz = ux * uinv, uy * uinv, uz * uinv

    # lambert (mg_ray_tracer.cpp:109-123)
    lx, ly, lz = nx + ux, ny + uy, nz + uz
    ln2 = lx * lx + ly * ly + lz * lz
    ldeg = ln2 < 1e-16
    linv = _rsqrt(torch.where(ldeg, 1.0, ln2))
    ndx = torch.where(ldeg, nx, lx * linv)
    ndy = torch.where(ldeg, ny, ly * linv)
    ndz = torch.where(ldeg, nz, lz * linv)

    dd = dx * nx + dy * ny + dz * nz
    rx, ry, rz = dx - 2.0 * dd * nx, dy - 2.0 * dd * ny, dz - 2.0 * dd * nz

    # metal (mg_ray_tracer.cpp:125-140)
    mx, my, mz = rx + brg * ux, ry + brg * uy, rz + brg * uz
    mabs = (mx * nx + my * ny + mz * nz) <= 0.0
    minv = _rsqrt(torch.clamp_min(mx * mx + my * my + mz * mz, 1e-30))
    is_met = bcl == 1.0
    ndx = torch.where(is_met, mx * minv, ndx)
    ndy = torch.where(is_met, my * minv, ndy)
    ndz = torch.where(is_met, mz * minv, ndz)

    # dielectric (sm_ray_tracer.cpp:181-219)
    inside = dd > 0.0
    sgn = torch.where(inside, -1.0, 1.0)
    onx, ony, onz = sgn * nx, sgn * ny, sgn * nz
    eta = torch.where(inside, brf, 1.0 / torch.clamp_min(brf, 1e-12))
    cosine = torch.where(inside, brf * dd, -dd)
    cos_i = -(dx * onx + dy * ony + dz * onz)
    sin2 = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2 > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2, 0.0))
    k = eta * cos_i - cos_t
    fx, fy, fz = eta * dx + k * onx, eta * dy + k * ony, eta * dz + k * onz
    r0 = (1.0 - brf) / (1.0 + brf)
    r0 = r0 * r0
    omc = 1.0 - cosine
    omc2 = omc * omc
    prob = torch.where(tir, 1.0, r0 + (1.0 - r0) * omc2 * omc2 * omc)
    refl_bit = coin < prob
    gx = torch.where(refl_bit, rx, fx)
    gy = torch.where(refl_bit, ry, fy)
    gz = torch.where(refl_bit, rz, fz)
    ginv = _rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-30))
    is_die = bcl == 2.0
    ndx = torch.where(is_die, gx * ginv, ndx)
    ndy = torch.where(is_die, gy * ginv, ndy)
    ndz = torch.where(is_die, gz * ginv, ndz)

    af = (live_h & ~(is_met & mabs)).to(f32)
    naf = 1.0 - af
    thr_n = (tr * (naf + af * bar * brf), tg * (naf + af * bag * brf),
             tb * (naf + af * bab * brf))

    lh = live_h.to(f32)
    nlh = 1.0 - lh
    o_n = (nlh * ox + lh * hx, nlh * oy + lh * hy, nlh * oz + lh * hz)
    d_n = (nlh * dx + lh * ndx, nlh * dy + lh * ndy, nlh * dz + lh * ndz)
    if replay:
        kind = torch.where(hit, torch.where(ispl, 2, 1), 0)
        if b_rows:
            kind = torch.where(hit & isbx, 3, kind)
        if replay == "blockwise":
            # the blockwise record kernel recomputes the root bit from the
            # winner's sphere row, an all-zero row unless a sphere won
            zb = ox * dx + oy * dy + oz * dz
            zdisc = zb * zb - (ox * ox + oy * oy + oz * oz)
            root = torch.where(kind == 1, root,
                               (-zb - torch.sqrt(torch.clamp_min(zdisc, 0.0))) >= _MIN_HIT)
            has_die = True
        else:
            # the unrolled kernel computes the Fresnel coin only where its
            # tables hold a dielectric (its class-presence specialization)
            has_die = any(r[9] == 2.0 for r in p_rows + s_rows) or any(r[11] == 2.0
                                                                       for r in b_rows)
        return rad, o_n, d_n, thr_n, af, _replay_record(
            lv, kind, win & WORD_ROW, root, refl_bit & has_die, ldeg, hit, af, (ux, uy, uz), coin)
    word = torch.where(live_h, win, WORD_MISS) if record else None
    return rad, o_n, d_n, thr_n, af, word


def _replay_record(lv, kind, idx, root, refl, ldeg, hit, af, u3, coin):
    """One bounce's replay record, as the record kernels write it
    (pallas_render.py:532-549): ``kind`` (0 miss, 1 sphere, 2 plane, 3
    box), ``idx`` (within its class) and ``bits`` (1 the sphere's near
    root, 2 the dielectric reflect, 4 the lambert degeneracy, 8 live and
    missed, 16 live in, 32 alive out), all int32 and 0 for a ray that was
    not live; the normalized unit vector and the coin of every ray."""
    bits = (root.to(torch.int32) + 2 * refl.to(torch.int32) + 4 * ldeg.to(torch.int32)
            + 8 * (lv & ~hit).to(torch.int32) + 16 + 32 * (af > 0.0).to(torch.int32))
    rec = {"kind": torch.where(lv, kind, 0), "idx": torch.where(lv, idx, 0),
           "bits": torch.where(lv, bits, 0)}
    rec = {k: v.to(torch.int32) for k, v in rec.items()}
    rec.update(urx=u3[0], ury=u3[1], urz=u3[2], coin=coin)
    return rec


def _raygen_plain(c, px, py, jx, jy, inv_w, inv_h):
    """Camera rays through (px + jx, py + jy) of the camera vector ``c``
    (Python floats), as trace.cuh's camera_ray: ``(o3, d3)``."""
    r = c[3:12]
    tan_half, aspect, near = c[12], c[13], c[14]
    nx_ = 2.0 * (px + jx) * inv_w - 1.0
    ny_ = 1.0 - 2.0 * (py + jy) * inv_h
    dvx = nx_ * tan_half * aspect
    dvy = ny_ * tan_half
    dwx = r[0] * dvx + r[1] * dvy - r[2]
    dwy = r[3] * dvx + r[4] * dvy - r[5]
    dwz = r[6] * dvx + r[7] * dvy - r[8]
    o3 = (c[0] + dwx * near, c[1] + dwy * near, c[2] + dwz * near)
    inv = _rsqrt(dwx * dwx + dwy * dwy + dwz * dwz)
    return o3, (dwx * inv, dwy * inv, dwz * inv)


def render_tile_plain(spheres, planes, boxes, cam, seeds, *, size, spp,
                      max_bounces, center_sample, rng_mode="reference", words=False, pix0=0,
                      count=None):
    """Plain PyTorch version of the kernel, on the device of ``cam``.

    Args:
      spheres, planes: (S, 10) / (P, 10) float32 rows of
        :func:`_flatten_primitives` (transposed).
      boxes: (B, 12) float32 rows of :func:`_flatten_boxes`; B = 0 leaves
        boxes untested.
      cam: (16,) float32 camera vector (:func:`_pack_camera`).
      seeds: (frames,) int32, one seed per frame.
      size: (width, height).
      spp: samples in this call; ``center_sample`` puts sample 0 at the
        pixel centre.

    Returns the SUM of pre-gamma radiance over the ``spp`` samples,
    (frames, height, width, 3) float32.  Every step mirrors the JAX kernel
    body (pallas_render.py:212-577) for ``record=False``: every bounce is
    computed for every ray and dead rays are masked out.  ``words=True``
    (one frame, one sample) returns ``(sum, words)`` with the winner word
    of every bounce, (max_bounces, height * width) int32 (the miss word
    once the path has ended): the blockwise kernel's words form.

    ``count`` (one frame; the blockwise kernel's shard of a frame) traces
    the pixels ``pix0 .. pix0 + count - 1`` only and returns (1, count, 3)
    and (max_bounces, count) words; a pixel at or past ``width * height``
    (a shard's padding) gives zeros and the miss word.
    """
    if words and (spp != 1 or seeds.shape[0] != 1):
        raise ValueError("render_tile_plain: words=True takes one frame of one sample")
    w, h = size
    dev = cam.device
    frames = seeds.shape[0]
    n = w * h
    if count is None:
        idx = torch.arange(n, device=dev, dtype=torch.int64).repeat(frames)
    elif frames != 1:
        raise ValueError("render_tile_plain: count takes one frame")
    else:
        idx = torch.arange(pix0, pix0 + count, device=dev, dtype=torch.int64)
    seed = seeds.to(torch.int64).repeat_interleave(idx.shape[0] // frames)
    px = (idx % w).to(torch.float32)
    py = (idx // w).to(torch.float32)
    inv_w, inv_h = _inv_size(w, h)
    c = cam.tolist()
    rows = (planes.tolist(), spheres.tolist(), boxes.tolist())
    rng_sphere = rng_mode == "sphere"
    per_sample = 2 + 4 * max_bounces

    def u01(ctr):
        return hash_u01(idx, seed, ctr)

    zero = torch.zeros_like(px)
    one = torch.ones_like(px)
    acc0 = acc1 = acc2 = zero
    bounce_words = []
    for smp in range(spp):
        base = smp * per_sample
        if smp == 0 and center_sample:
            jx = jy = 0.5
        else:
            jx, jy = u01(base + 1), u01(base + 2)
        o3, d3 = _raygen_plain(c, px, py, jx, jy, inv_w, inv_h)
        thr3 = (one, one, one)
        live = one
        for b in range(max_bounces):
            ctr = base + 2 + 4 * b
            u3 = (u01(ctr + 1), u01(ctr + 2), u01(ctr + 3))
            rad, o3, d3, thr3, live, word = _bounce_plain(rows, o3, d3, thr3, live, u3,
                                                          u01(ctr + 4), rng_sphere, words)
            acc0, acc1, acc2 = acc0 + rad[0], acc1 + rad[1], acc2 + rad[2]
            if words:
                bounce_words.append(word.to(torch.int32))

    out = torch.stack([acc0, acc1, acc2], dim=-1)
    wd = (torch.stack(bounce_words) if bounce_words
          else torch.zeros((0, idx.shape[0]), dtype=torch.int32, device=dev))
    if count is None:
        out = out.reshape(frames, h, w, 3)
    else:
        inside = idx < n
        out = torch.where(inside[:, None], out, 0.0).reshape(1, count, 3)
        wd = torch.where(inside, wd, WORD_MISS)
    return (out, wd) if words else out


@functools.cache
def _kernel():
    from ._build import load_library

    fn = load_library("render_kernel").rt_render_forward
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, p, p, p, i, i, i, f, f, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"render_tile: {name} must be a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"render_tile: {name} has shape {tuple(t.shape)}, expected {shape}")


def render_tile(spheres, planes, boxes, cam, seeds, *, size, spp, max_bounces,
                center_sample, rng_mode="reference"):
    """One call of the megakernel; arguments and result as
    :func:`render_tile_plain`.  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream (without
    synchronizing) or raise."""
    dev = cam.device
    for name, t in (("spheres", spheres), ("planes", planes), ("boxes", boxes), ("seeds", seeds)):
        if t.device != dev:
            raise ValueError(f"render_tile: {name} is on {t.device} but cam on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if dev.type == "cpu":
        return render_tile_plain(spheres, planes, boxes, cam, seeds, size=size, spp=spp,
                                 max_bounces=max_bounces, center_sample=center_sample,
                                 rng_mode=rng_mode)
    if dev.type != "cuda":
        raise ValueError(f"render_tile: no kernel for device {dev}")
    w, h = size
    f32 = torch.float32
    _check("spheres", spheres, f32, (None, 10), dev)
    _check("planes", planes, f32, (None, 10), dev)
    _check("boxes", boxes, f32, (None, 12), dev)
    _check("cam", cam, f32, (16,), dev)
    _check("seeds", seeds, torch.int32, (None,), dev)
    frames = seeds.shape[0]
    if spheres.shape[0] + planes.shape[0] + boxes.shape[0] > MAX_UNROLL_PRIMS:
        raise ValueError(f"render_tile: more than {MAX_UNROLL_PRIMS} primitives")
    if w < 1 or h < 1 or frames < 1 or w * h * frames >= 2**31:
        raise ValueError(f"render_tile: bad size {w}x{h} x {frames} frames")
    if spp < 1 or max_bounces < 0:
        raise ValueError(f"render_tile: bad spp={spp} / max_bounces={max_bounces}")
    out = torch.empty((frames, h, w, 3), dtype=f32, device=dev)
    inv_w, inv_h = _inv_size(w, h)
    with torch.cuda.device(dev):
        err = _kernel()(
            spheres.data_ptr(), spheres.shape[0], planes.data_ptr(), planes.shape[0],
            boxes.data_ptr(), boxes.shape[0], cam.data_ptr(), seeds.data_ptr(),
            out.data_ptr(), w, h, frames, inv_w, inv_h, spp, max_bounces,
            int(bool(center_sample)), int(rng_mode == "sphere"),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render kernel launch failed: CUDA error {err}")
    render_tile.launches += 1
    return out


render_tile.launches = 0


def _pack_camera(camera, size) -> np.ndarray:
    """The 16-float camera vector: position, row-major rotation, then
    tan(vfov/2), w/h and near computed in float64 and rounded to float32
    (pallas_render.py:833-839)."""
    w, h = size
    return np.concatenate([
        _np(camera.position).astype(np.float32),
        _np(camera.rotation).astype(np.float32).reshape(-1),
        np.asarray([np.tan(camera.vfov * 0.5), w / h, camera.near, 0.0], np.float32),
    ])


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available "
                           "(pass device='cpu' for the plain PyTorch version)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array → tensor on ``dev``; a CUDA copy goes through pinned
    memory without blocking the host."""
    with span("rt.upload"):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t


def _frame_renderer(scene, size, *, personality, spp, max_bounces, gamma, rng_mode,
                    include_boxes, frames, device):
    """Shared body of the entry points: uploads the tables once and returns
    ``run(cam, seed) -> (frames, H, W, 3)``."""
    if not supported(scene, include_boxes):
        raise ValueError(
            "scene exceeds the megakernel's limits "
            f"({MAX_UNROLL_PRIMS} primitives); larger scenes take the blockwise "
            "route (ops.blockwise.render_forward_blockwise)")
    dev = _device(device)
    w, h = size
    spp = scene.samples_per_pixel if spp is None else spp
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces

    with span("rt.tables"):
        s_cols, p_cols = _flatten_primitives(scene, personality)
        b_cols = (_flatten_boxes(scene, personality) if include_boxes
                  else np.zeros((12, 0), np.float32))
        spheres, planes, boxes = (_upload(c.T, dev) for c in (s_cols, p_cols, b_cols))

    def launch(cam, seeds, k, center):
        return render_tile(spheres, planes, boxes, cam, seeds, size=(w, h), spp=k,
                           max_bounces=max_bounces, center_sample=center, rng_mode=rng_mode)

    def run(cam: torch.Tensor, seed: int) -> torch.Tensor:
        return _chunked_frame(launch, cam, seed, spp, frames, gamma, dev)

    return run, dev


def _chunked_frame(launch, cam, seed: int, spp: int, frames: int, gamma: bool, dev,
                   chunk: int = _SPP_CHUNK):
    """The frame of ``spp`` samples from calls of at most ``chunk`` samples,
    ``launch(cam, seeds, k, center_sample) -> sum of k samples``: chunk
    seeds from :func:`_chunk_seeds` (uploaded in one copy), the chunk sums
    added in chunk order, times float32(1/spp), then gamma (sqrt)."""
    chunks = [min(chunk, spp - s) for s in range(0, spp, chunk)]
    seeds = _upload(_chunk_seeds(seed, len(chunks), frames), dev)
    total = None
    for ci, k in enumerate(chunks):
        out = launch(cam, seeds[ci], k, ci == 0)
        if total is None:
            total = out
        else:
            with span("rt.assemble"):
                total = total + out
    with span("rt.assemble"):
        img = total * float(np.float32(1.0 / spp))
        if gamma:
            img = torch.sqrt(torch.clamp_min(img, 0.0))
    return img


def render_forward(
    scene,
    size: tuple[int, int],
    seed: int = 0,
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    gamma: bool = True,
    rng_mode: str = "reference",
    include_boxes: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Render a full frame.  Returns (H, W, 3) float32 on ``device``.

    ``include_boxes`` traces the box slab test too (the ``--boxes``
    extension; default off = the reference's box stub).  With
    ``device="cpu"`` the plain PyTorch version renders.
    """
    run, dev = _frame_renderer(
        scene, size, personality=personality, spp=spp, max_bounces=max_bounces,
        gamma=gamma, rng_mode=rng_mode, include_boxes=include_boxes, frames=1,
        device=device)
    return run(_upload(_pack_camera(scene.camera, size), dev), seed)[0]


def make_render_step(
    scene,
    size: tuple[int, int],
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    gamma: bool = True,
    rng_mode: str = "reference",
    include_boxes: bool = False,
    frames: int = 1,
    device="cuda",
):
    """Prebuilt frame renderer: ``step(seed=0, camera=None) -> (H, W, 3)``,
    or ``(frames, H, W, 3)`` when ``frames`` > 1 (frames seeded seed ..
    seed+frames-1, one launch per sample chunk for all of them).

    The tables and the camera go to the device once; each call then ships
    the seed matrix (plus 16 floats when ``camera`` — a
    :class:`rt_tpu_torch.scene.Camera` — is passed for motion).
    """
    run, dev = _frame_renderer(
        scene, size, personality=personality, spp=spp, max_bounces=max_bounces,
        gamma=gamma, rng_mode=rng_mode, include_boxes=include_boxes, frames=frames,
        device=device)
    cam0 = _upload(_pack_camera(scene.camera, size), dev)

    def step(seed: int = 0, camera=None) -> torch.Tensor:
        cam = cam0 if camera is None else _upload(_pack_camera(camera, size), dev)
        img = run(cam, seed)
        return img[0] if frames == 1 else img

    return step


# ---------------------------------------------------------------------------
# the record kernel: one sample per pixel and the replay records
# ---------------------------------------------------------------------------

# the raw record set of one call: (B, S * N) per bounce, jitter (2, S * N)
RECORD_KEYS = ("kind", "idx", "bits", "urx", "ury", "urz", "coin")


def _record_plain(rows, cam, seeds, *, size, max_bounces, center_sample, rng_mode, replay):
    """The record kernels' function, dense over the ``S * N`` rays of the
    ``(S,)`` seeds (sample-major, ray t the pixel t % N of sample t / N at
    ``seeds[t / N]``, sample 0 alone at the centre with ``center_sample``):
    ``rows`` as :func:`_bounce_plain` takes them, ``replay`` the record
    conventions ("unrolled" or "blockwise").  Returns ``(rad, recs)`` as
    :func:`render_record_tile_plain`."""
    w, h = size
    dev = cam.device
    n = w * h
    s_count = seeds.shape[0]
    ray = torch.arange(s_count * n, device=dev, dtype=torch.int64)
    idx = ray % n
    seed = seeds.to(device=dev, dtype=torch.int64).repeat_interleave(n)
    px = (idx % w).to(torch.float32)
    py = (idx // w).to(torch.float32)
    inv_w, inv_h = _inv_size(w, h)
    jx, jy = hash_u01(idx, seed, 1), hash_u01(idx, seed, 2)
    if center_sample:
        first = ray < n
        jx, jy = (torch.where(first, torch.full_like(px, 0.5), j) for j in (jx, jy))
    o3, d3 = _raygen_plain(cam.tolist(), px, py, jx, jy, inv_w, inv_h)
    one = torch.ones_like(px)
    thr3, live = (one, one, one), one
    acc = [one * 0.0] * 3
    per_bounce = []
    for b in range(max_bounces):
        ctr = 2 + 4 * b
        u3 = (hash_u01(idx, seed, ctr + 1), hash_u01(idx, seed, ctr + 2),
              hash_u01(idx, seed, ctr + 3))
        rad, o3, d3, thr3, live, rec = _bounce_plain(rows, o3, d3, thr3, live, u3,
                                                     hash_u01(idx, seed, ctr + 4),
                                                     rng_mode == "sphere", replay=replay)
        acc = [a + r for a, r in zip(acc, rad)]
        per_bounce.append(rec)
    recs = {k: (torch.stack([r[k] for r in per_bounce]) if max_bounces else
                torch.zeros((0, s_count * n), dtype=torch.int32 if k in ("kind", "idx", "bits")
                            else torch.float32, device=dev)) for k in RECORD_KEYS}
    recs["jitter"] = torch.stack([jx, jy])
    return torch.stack(acc, dim=-1).reshape(s_count, h, w, 3), recs


def render_record_tile_plain(spheres, planes, boxes, cam, seeds, *, size, max_bounces,
                             center_sample, rng_mode="reference"):
    """Plain PyTorch version of the record kernel, on the device of ``cam``.

    Arguments as :func:`render_tile_plain`, with ``seeds`` (S,) int32: one
    sample per pixel at each seed, ``center_sample`` putting sample 0 (and
    only it) at the pixel centre, as the JAX records pipeline's first call.

    Returns ``(rad, recs)``: the pre-gamma radiance (S, H, W, 3) float32
    (sample s is the 1-spp frame of :func:`render_tile_plain` at
    ``seeds[s]``), and the raw records in the sample-concatenated layout
    the replay reads: for every bounce b and column ``s * N + i`` (pixel i
    of sample s), ``recs[k][b, s * N + i]`` for k in :data:`RECORD_KEYS`
    (kind, idx, bits: int32, 0 once the path has ended; the normalized
    unit vector urx/ury/urz and the coin: float32, every bounce's draws),
    and ``recs["jitter"]`` (2, S * N) float32.  Each sample's columns are
    the one-sample call's at its seed.  Every step mirrors the JAX kernel
    body with ``record=True`` (pallas_render.py:212-577), including its
    class-presence specialization: the reflect bit is computed only where
    a table holds a dielectric.  :func:`records_to_flat` decodes the
    records."""
    return _record_plain((planes.tolist(), spheres.tolist(), boxes.tolist()), cam, seeds,
                         size=size, max_bounces=max_bounces, center_sample=center_sample,
                         rng_mode=rng_mode, replay="unrolled")


@functools.cache
def _record_kernel():
    from ._build import load_library

    fn = load_library("render_kernel").rt_render_record
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, p, p, i, p, p, i, i, f, f, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _record_outputs(w, h, max_bounces, samples, dev):
    """Empty record outputs on ``dev`` for ``samples`` samples, from one
    int32 and one float32 allocation (in rt_render_record's order): the
    buffers ``(ints, floats)``, the radiance (S, H, W, 3) and the raw
    records (:data:`RECORD_KEYS` (B, S * N) each, jitter (2, S * N))."""
    m = w * h * samples
    ints = torch.empty(3 * max_bounces * m, dtype=torch.int32, device=dev)
    floats = torch.empty((4 * max_bounces + 5) * m, dtype=torch.float32, device=dev)
    recs = dict(zip(RECORD_KEYS, (*ints.view(3, max_bounces, m),
                                  *floats[:4 * max_bounces * m].view(4, max_bounces, m))))
    recs["jitter"] = floats[4 * max_bounces * m:(4 * max_bounces + 2) * m].view(2, m)
    rad = floats[(4 * max_bounces + 2) * m:].view(samples, h, w, 3)
    return (ints, floats), rad, recs


def render_record_tile(spheres, planes, boxes, cam, seeds, *, size, max_bounces, center_sample,
                       rng_mode="reference"):
    """One launch of the record kernel for every seed of ``seeds`` (S,);
    arguments and result as :func:`render_record_tile_plain`.  CPU tensors
    run the plain version; CUDA tensors launch the kernel on the current
    stream (without synchronizing) or raise."""
    fn = "render_record_tile"
    dev = cam.device
    for name, t in (("spheres", spheres), ("planes", planes), ("boxes", boxes), ("seeds", seeds)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device} but cam on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if dev.type == "cpu":
        return render_record_tile_plain(spheres, planes, boxes, cam, seeds, size=size,
                                        max_bounces=max_bounces, center_sample=center_sample,
                                        rng_mode=rng_mode)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    w, h = size
    f32 = torch.float32
    _check("spheres", spheres, f32, (None, 10), dev)
    _check("planes", planes, f32, (None, 10), dev)
    _check("boxes", boxes, f32, (None, 12), dev)
    _check("cam", cam, f32, (16,), dev)
    _check("seeds", seeds, torch.int32, (None,), dev)
    samples = seeds.shape[0]
    if spheres.shape[0] + planes.shape[0] + boxes.shape[0] > MAX_UNROLL_PRIMS:
        raise ValueError(f"{fn}: more than {MAX_UNROLL_PRIMS} primitives")
    if (w < 1 or h < 1 or samples < 1 or max_bounces < 0
            or w * h * samples * max(max_bounces, 3) >= 2**31):
        raise ValueError(f"{fn}: bad size {w}x{h} x {samples} samples or "
                         f"max_bounces={max_bounces}")
    (ints, floats), rad, recs = _record_outputs(w, h, max_bounces, samples, dev)
    inv_w, inv_h = _inv_size(w, h)
    with torch.cuda.device(dev):
        err = _record_kernel()(
            spheres.data_ptr(), spheres.shape[0], planes.data_ptr(), planes.shape[0],
            boxes.data_ptr(), boxes.shape[0], cam.data_ptr(), seeds.data_ptr(), samples,
            ints.data_ptr(), floats.data_ptr(), w, h, inv_w, inv_h, max_bounces,
            int(bool(center_sample)), int(rng_mode == "sphere"),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"record kernel launch failed: CUDA error {err}")
    render_record_tile.launches += 1
    return rad, recs


render_record_tile.launches = 0


def render_record(scene, size, seed: int, *, personality: str = "mg",
                  max_bounces: Optional[int] = None, rng_mode: str = "reference",
                  center_sample: bool = True, include_boxes: bool = False, device="cuda"):
    """One sample per pixel through the record kernel (the counterpart of
    ``render_record_pallas``).  Returns ``(rad, recs)`` on ``device``: the
    radiance (H, W, 3) and the records of :func:`render_record_tile` at the
    one seed (kind=3 records and the box index with ``include_boxes``);
    :func:`records_to_flat` decodes ``recs`` into the layout
    :func:`rt_tpu_torch.replay.replay_radiance` takes."""
    if not supported(scene, include_boxes):
        raise ValueError("scene exceeds the unrolled megakernel limits")
    dev = _device(device)
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    s_cols, p_cols = _flatten_primitives(scene, personality)
    b_cols = (_flatten_boxes(scene, personality) if include_boxes
              else np.zeros((12, 0), np.float32))
    spheres, planes, boxes = (_upload(c.T, dev) for c in (s_cols, p_cols, b_cols))
    rad, recs = render_record_tile(spheres, planes, boxes,
                                   _upload(_pack_camera(scene.camera, size), dev),
                                   _upload(np.asarray([seed], np.int32), dev), size=size,
                                   max_bounces=max_bounces, center_sample=center_sample,
                                   rng_mode=rng_mode)
    return rad[0], recs


def records_to_flat(recs: dict) -> dict:
    """Raw records (:func:`render_record_tile`) -> the flat dict of
    ``pallas_render.records_to_flat``: kind and idx (B, N) int32, the six
    decoded bits (B, N) bool, the unit vectors ``ur`` (B, N, 3), the coins
    (B, N) and the jitter (N, 2)."""
    bits = recs["bits"]
    return {
        "kind": recs["kind"],
        "idx": recs["idx"],
        "root_lo": (bits & 1) > 0,
        "reflect_bit": (bits & 2) > 0,
        "lam_deg": (bits & 4) > 0,
        "miss": (bits & 8) > 0,
        "live_in": (bits & 16) > 0,
        "alive_out": (bits & 32) > 0,
        "ur": torch.stack([recs["urx"], recs["ury"], recs["urz"]], dim=-1),
        "coin": recs["coin"],
        "jitter": recs["jitter"].T,
    }
