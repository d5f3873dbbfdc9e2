"""Per-ray math of the fused gradient kernels, in plain PyTorch.

Counterpart of the device code that ``rt_tpu.ops.pallas_grad``'s mono and
per-sample kernels share: the closest-hit scan (``_make_scan``), the
forward bounce with its decision bits (``_bounce_forward``), the payload
rebuilt from the winner's index, the raygen, and the adjoints of the
smooth bounce map (``_bounce_smooth``) and of the raygen.  The JAX kernels
take those adjoints from ``jax.vjp`` traced inside the kernel; here they
are written by hand (extending ``_bounce_reverse_noplanes`` to planes and
to every material class), expression for expression as
``csrc/grad_kernel.cu`` writes them, so that the kernel and this code make
the same per-ray decisions and round every operation alike.

Every function works on dense tensors, one element per ray; decision bits
are bool tensors and a decision selects with ``torch.where``, where the
CUDA code branches.  A branch that the mask turns off contributes exact
zeros here, so the two agree.

Conventions kept from the JAX package:

* Decisions (winner, near/far root, lambert degeneracy, metal absorption,
  the dielectric coin, total internal reflection, inside/outside) are
  pinned: they get no gradient (detached sampling).
* The adjoint recomputes the primal from the stashed (origin, direction,
  throughput) and the winner's payload, with ``t`` from
  ``sqrt(max(disc, 1e-12))`` where the scan clamped at 0.
* ``max(x, eps)`` gates: the JAX vjp splits an exact tie 50/50, the hand
  adjoint gives it to the ``>`` side (``_bounce_reverse_noplanes``'s
  convention).  Ties are measure-zero.
* The cotangents of a plane's normal and offset are not computed: the
  gradient pytree (``_assemble_grads``) reads only the material slots of
  planes.
"""

from __future__ import annotations

import torch

from .render import _BIG, _MIN_HIT, _rsqrt, hash_u01

__all__ = ["BITS", "scan", "payload", "unit_draws", "decisions", "bounce_forward",
           "bounce_adjoint", "raygen", "raygen_adjoint"]

_w = torch.where

# decision bits of the packed stash word (bit k = BITS[k]; the winner's
# index rides bits 16..25); "alive" already folds in the metal absorb test
BITS = ("hit", "live_h", "miss", "alive", "ispl", "root", "ldeg", "refl", "tir", "inside",
        "is_met", "is_die")


def scan(spheres, planes, o3, d3):
    """Closest hit over the (S, 10) / (P, 10) tables: planes first with
    strict '<', a sphere wins a tie against a plane, strict '<' among
    spheres (pallas_grad ``_make_scan``).

    Returns ``(best_t, bidx, ispl, root)``: the hit distance (``_BIG`` on a
    miss), the winner's row (int64), whether it is a plane, and whether a
    sphere winner was hit at its near root."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    best = torch.full_like(ox, _BIG)
    bidx = torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    ispl = torch.zeros(ox.shape, dtype=torch.bool, device=ox.device)
    root = torch.ones(ox.shape, dtype=torch.bool, device=ox.device)
    for p, (pnx, pny, pnz, pdd) in enumerate(planes[:, :4].tolist()):
        nd = pnx * dx + pny * dy + pnz * dz
        no = pnx * ox + pny * oy + pnz * oz + pdd
        nz_ok = nd.abs() > 1e-12
        t = -no / _w(nz_ok, nd, 1.0)
        ok = nz_ok & (t >= _MIN_HIT) & (t < best)
        best = _w(ok, t, best)
        bidx = _w(ok, p, bidx)
        ispl = ispl | ok
    for i, (cx, cy, cz, rad) in enumerate(spheres[:, :4].tolist()):
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        bq = ocx * dx + ocy * dy + ocz * dz
        c0 = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = bq * bq - c0
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t0 = -bq - sq
        t1 = -bq + sq
        near = t0 >= _MIN_HIT
        t = _w(near, t0, t1)
        ok = (disc >= 0.0) & (t >= _MIN_HIT) & ((t < best) | ((t == best) & ispl))
        best = _w(ok, t, best)
        bidx = _w(ok, i, bidx)
        ispl = ispl & ~ok
        root = _w(ok, near, root)
    return best, bidx, ispl, root


def payload(spheres, planes, hit, ispl, bidx):
    """The winner's 13 payload values rebuilt from its table row
    (pallas_grad.py:1626-1670): centre x/y/z, radius, plane normal x/y/z,
    plane offset, albedo r/g/b, reflectivity, roughness — plus its
    material class.  A miss, and the other kind's fields, keep the scan's
    defaults (zeros; radius and reflectivity 1)."""
    zero = torch.zeros_like(bidx, dtype=torch.float32)
    sph = hit & ~ispl
    pln = hit & ispl
    cols = [zero] * 10
    defaults = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    srow = spheres[bidx.clamp(max=spheres.shape[0] - 1)] if spheres.shape[0] else None
    prow = planes[bidx.clamp(max=planes.shape[0] - 1)] if planes.shape[0] else None
    geo_s = [_w(sph, srow[:, k], defaults[k]) if srow is not None else zero + defaults[k]
             for k in range(4)]
    geo_p = [_w(pln, prow[:, k], 0.0) if prow is not None else zero for k in range(4)]
    for k in range(4, 10):
        v = zero + defaults[k]
        if srow is not None:
            v = _w(sph, srow[:, k], v)
        if prow is not None:
            v = _w(pln, prow[:, k], v)
        cols[k] = v
    return tuple(geo_s) + tuple(geo_p) + tuple(cols[4:9]), cols[9]


def unit_draws(idx, seed, ctr, rng_sphere):
    """The scatter unit vector of a bounce: hash draws at counters
    ``ctr``..``ctr+2``, mapped to [-1, 1) for ``rng_sphere``, normalised."""
    ux, uy, uz = (hash_u01(idx, seed, ctr + i) for i in range(3))
    if rng_sphere:
        ux, uy, uz = 2.0 * ux - 1.0, 2.0 * uy - 1.0, 2.0 * uz - 1.0
    uinv = _rsqrt(torch.clamp_min(ux * ux + uy * uy + uz * uz, 1e-30))
    return ux * uinv, uy * uinv, uz * uinv


def _decide(o3, d3, lv, best_t, pay, cls, ispl, root, u3, coin):
    """:func:`decisions` and the values the forward bounce reuses: the hit
    point, the normal, the lambert sum and its squared length, d.n and the
    metal lobe."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    bcx, bcy, bcz, _brad, pnx, pny, pnz, _pdd, _bar, _bag, _bab, brf, brg = pay
    ux, uy, uz = u3

    hit = best_t < 1e37
    live_h = lv & hit
    miss = lv & ~hit
    t_safe = _w(hit, best_t, 0.0)
    h3 = (ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz)
    snx, sny, snz = h3[0] - bcx, h3[1] - bcy, h3[2] - bcz
    sinv = _rsqrt(torch.clamp_min(snx * snx + sny * sny + snz * snz, 1e-30))
    nx = _w(ispl, pnx, snx * sinv)
    ny = _w(ispl, pny, sny * sinv)
    nz = _w(ispl, pnz, snz * sinv)

    # lambert (mg_ray_tracer.cpp:109-123)
    l3 = (nx + ux, ny + uy, nz + uz)
    ln2 = l3[0] * l3[0] + l3[1] * l3[1] + l3[2] * l3[2]
    ldeg = ln2 < 1e-16

    # metal (mg_ray_tracer.cpp:125-140)
    ddot = dx * nx + dy * ny + dz * nz
    r3 = (dx - 2.0 * ddot * nx, dy - 2.0 * ddot * ny, dz - 2.0 * ddot * nz)
    m3 = (r3[0] + brg * ux, r3[1] + brg * uy, r3[2] + brg * uz)
    mabs = (m3[0] * nx + m3[1] * ny + m3[2] * nz) <= 0.0
    is_met = cls == 1.0

    # dielectric (sm_ray_tracer.cpp:181-219)
    inside = ddot > 0.0
    eta = _w(inside, brf, 1.0 / torch.clamp_min(brf, 1e-12))
    cosine = _w(inside, brf * ddot, -ddot)
    cos_i = _w(inside, ddot, -ddot)
    sin2 = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2 > 1.0
    r0 = (1.0 - brf) / (1.0 + brf)
    r0 = r0 * r0
    omc = 1.0 - cosine
    omc2 = omc * omc
    prob = _w(tir, 1.0, r0 + (1.0 - r0) * omc2 * omc2 * omc)
    refl = coin < prob
    is_die = cls == 2.0

    alive = live_h & ~(is_met & mabs)
    bits = dict(hit=hit, live_h=live_h, miss=miss, alive=alive, ispl=ispl, root=root,
                ldeg=ldeg, refl=refl, tir=tir, inside=inside, is_met=is_met, is_die=is_die)
    geo = dict(h3=h3, n3=(nx, ny, nz), l3=l3, ln2=ln2, ddot=ddot, r3=r3, m3=m3, eta=eta,
               cos_i=cos_i, sin2=sin2)
    return bits, geo


def decisions(o3, d3, lv, best_t, pay, cls, ispl, root, u3, coin):
    """Decision bits of one bounce (pallas_grad ``_decisions``; bounce.cuh
    ``decisions``): from the ray entering the bounce, whether it is live,
    the winner (distance ``best_t``, ``_BIG`` on a miss; payload and
    class; plane or sphere; near root) and the bounce's unit vector and
    coin.  Returns the dict of bool tensors keyed by :data:`BITS`."""
    return _decide(o3, d3, lv, best_t, pay, cls, ispl, root, u3, coin)[0]


def bounce_forward(o3, d3, thr3, best_t, pay, cls, ispl, root, lv, u3, coin):
    """One forward bounce with its decision bits (pallas_grad
    ``_bounce_forward``; the dielectric is written as there, not as in the
    render kernel).  The bits are :func:`decisions`'s and the advance
    follows them.  Returns ``(o', d', thr', radiance, bits)``."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    tr, tg, tb = thr3
    bar, bag, bab, brf = pay[8:12]
    bits, geo = _decide(o3, d3, lv, best_t, pay, cls, ispl, root, u3, coin)
    hx, hy, hz = geo["h3"]
    nx, ny, nz = geo["n3"]
    lx, ly, lz = geo["l3"]
    ldeg, inside, tir, refl = bits["ldeg"], bits["inside"], bits["tir"], bits["refl"]

    ts = 0.5 * (dy + 1.0)
    mf = bits["miss"].to(torch.float32)
    rad = (mf * tr * (1.0 - 0.5 * ts), mf * tg * (1.0 - 0.3 * ts), mf * tb)

    linv = _rsqrt(_w(ldeg, 1.0, torch.clamp_min(geo["ln2"], 1e-30)))
    ndx = _w(ldeg, nx, lx * linv)
    ndy = _w(ldeg, ny, ly * linv)
    ndz = _w(ldeg, nz, lz * linv)

    mx, my, mz = geo["m3"]
    minv = _rsqrt(torch.clamp_min(mx * mx + my * my + mz * mz, 1e-30))
    is_met = bits["is_met"]
    ndx = _w(is_met, mx * minv, ndx)
    ndy = _w(is_met, my * minv, ndy)
    ndz = _w(is_met, mz * minv, ndz)

    rx, ry, rz = geo["r3"]
    sgn = _w(inside, -1.0, 1.0)
    onx, ony, onz = sgn * nx, sgn * ny, sgn * nz
    eta, cos_i, sin2 = geo["eta"], geo["cos_i"], geo["sin2"]
    cos_t = torch.sqrt(_w(tir, 1.0, torch.clamp_min(1.0 - sin2, 1e-12)))
    cos_t = _w(tir, 0.0, cos_t)
    ecc = eta * cos_i - cos_t
    fx, fy, fz = eta * dx + ecc * onx, eta * dy + ecc * ony, eta * dz + ecc * onz
    gx, gy, gz = _w(refl, rx, fx), _w(refl, ry, fy), _w(refl, rz, fz)
    ginv = _rsqrt(torch.clamp_min(gx * gx + gy * gy + gz * gz, 1e-30))
    is_die = bits["is_die"]
    ndx = _w(is_die, gx * ginv, ndx)
    ndy = _w(is_die, gy * ginv, ndy)
    ndz = _w(is_die, gz * ginv, ndz)

    af = bits["alive"].to(torch.float32)
    naf = 1.0 - af
    thr_n = (tr * (naf + af * bar * brf), tg * (naf + af * bag * brf), tb * (naf + af * bab * brf))
    lh = bits["live_h"].to(torch.float32)
    nlh = 1.0 - lh
    o_n = (nlh * ox + lh * hx, nlh * oy + lh * hy, nlh * oz + lh * hz)
    d_n = (nlh * dx + lh * ndx, nlh * dy + lh * ndy, nlh * dz + lh * ndz)
    return o_n, d_n, thr_n, rad, bits


def bounce_adjoint(o3, d3, thr3, pay, u3, bits, co, cd, ct, crad):
    """Hand-written transpose of the pinned smooth bounce map
    (pallas_grad ``_bounce_smooth``) for every scene class: sphere or plane
    winner, lambert (with and without degeneracy), metal, the dielectric
    family, miss and dead rays.

    ``co``, ``cd``, ``ct``: cotangents of the bounce's outgoing origin,
    direction and throughput; ``crad``: of its radiance (the pixel
    cotangent).  Returns the cotangents of the incoming origin, direction
    and throughput, and the nine payload slots (centre x/y/z, radius,
    albedo r/g/b, reflectivity, roughness)."""
    f32 = torch.float32
    ox, oy, oz = o3
    dx, dy, dz = d3
    tr, tg, tb = thr3
    bcx, bcy, bcz, brad, pnx, pny, pnz, pdd, bar, bag, bab, brf, brg = pay
    ux, uy, uz = u3
    hit, ispl, root, ldeg = bits["hit"], bits["ispl"], bits["root"], bits["ldeg"]
    refl, tir, inside = bits["refl"], bits["tir"], bits["inside"]
    is_met, is_die = bits["is_met"], bits["is_die"]
    mf = bits["miss"].to(f32)
    af = bits["alive"].to(f32)
    lh = bits["live_h"].to(f32)
    naf = 1.0 - af
    nlh = 1.0 - lh

    # ---- primal recompute ----
    ocx, ocy, ocz = ox - bcx, oy - bcy, oz - bcz
    bq = ocx * dx + ocy * dy + ocz * dz
    c0 = ocx * ocx + ocy * ocy + ocz * ocz - brad * brad
    disc = bq * bq - c0
    sq = torch.sqrt(torch.clamp_min(disc, 1e-12))
    t_s = _w(root, -bq - sq, -bq + sq)
    ndd = pnx * dx + pny * dy + pnz * dz
    nz_ok = ndd.abs() > 1e-12
    safe = _w(nz_ok, ndd, 1.0)
    num = pnx * ox + pny * oy + pnz * oz + pdd
    t_p = -num / safe
    t = _w(hit, _w(ispl, t_p, t_s), 0.0)
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    snx, sny, snz = hx - bcx, hy - bcy, hz - bcz
    sn2 = snx * snx + sny * sny + snz * snz
    sinv = _rsqrt(torch.clamp_min(sn2, 1e-30))
    nx = _w(ispl, pnx, snx * sinv)
    ny = _w(ispl, pny, sny * sinv)
    nz = _w(ispl, pnz, snz * sinv)
    lxx, lxy, lxz = nx + ux, ny + uy, nz + uz
    ln2 = lxx * lxx + lxy * lxy + lxz * lxz
    linv = _rsqrt(_w(ldeg, 1.0, torch.clamp_min(ln2, 1e-30)))
    ddot = dx * nx + dy * ny + dz * nz
    rx, ry, rz = dx - 2.0 * ddot * nx, dy - 2.0 * ddot * ny, dz - 2.0 * ddot * nz
    mx, my, mz = rx + brg * ux, ry + brg * uy, rz + brg * uz
    m2 = mx * mx + my * my + mz * mz
    minv = _rsqrt(torch.clamp_min(m2, 1e-30))
    sgn = _w(inside, -1.0, 1.0)
    onx, ony, onz = sgn * nx, sgn * ny, sgn * nz
    mbrf = torch.clamp_min(brf, 1e-12)
    eta = _w(inside, brf, 1.0 / mbrf)
    cos_i = _w(inside, ddot, -ddot)
    sin2 = eta * eta * (1.0 - cos_i * cos_i)
    wct = _w(tir, 1.0, torch.clamp_min(1.0 - sin2, 1e-12))
    sct = torch.sqrt(wct)
    cos_t = _w(tir, 0.0, sct)
    ecc = eta * cos_i - cos_t
    fx, fy, fz = eta * dx + ecc * onx, eta * dy + ecc * ony, eta * dz + ecc * onz
    gx, gy, gz = _w(refl, rx, fx), _w(refl, ry, fy), _w(refl, rz, fz)
    g2 = gx * gx + gy * gy + gz * gz
    ginv = _rsqrt(torch.clamp_min(g2, 1e-30))
    ts = 0.5 * (dy + 1.0)

    # ---- transpose ----
    Cox_, Coy_, Coz_ = co
    Cdx_, Cdy_, Cdz_ = cd
    Ctr_, Ctg_, Ctb_ = ct
    Crr, Crg, Crb = crad

    # o' = nlh o + lh h ; d' = nlh d + lh nd
    Cox, Coy, Coz = nlh * Cox_, nlh * Coy_, nlh * Coz_
    Chx, Chy, Chz = lh * Cox_, lh * Coy_, lh * Coz_
    Cdx, Cdy, Cdz = nlh * Cdx_, nlh * Cdy_, nlh * Cdz_
    Cndx, Cndy, Cndz = lh * Cdx_, lh * Cdy_, lh * Cdz_

    # thr'_c = thr_c (naf + af alb_c brf)
    Ctr = Ctr_ * (naf + af * bar * brf)
    Ctg = Ctg_ * (naf + af * bag * brf)
    Ctb = Ctb_ * (naf + af * bab * brf)
    Cbar = Ctr_ * tr * af * brf
    Cbag = Ctg_ * tg * af * brf
    Cbab = Ctb_ * tb * af * brf
    Cbrf = af * (Ctr_ * tr * bar + Ctg_ * tg * bag + Ctb_ * tb * bab)

    # sky on miss: rad = (mf tr (1 - .5 ts), mf tg (1 - .3 ts), mf tb), ts = .5 (dy + 1)
    Ctr = Ctr + Crr * mf * (1.0 - 0.5 * ts)
    Ctg = Ctg + Crg * mf * (1.0 - 0.3 * ts)
    Ctb = Ctb + Crb * mf
    Cdy = Cdy + 0.5 * (mf * tr * (-0.5) * Crr + mf * tg * (-0.3) * Crg)

    # nd = where(is_die, g ginv, where(is_met, m minv, l))
    Cggx, Cggy, Cggz = _w(is_die, Cndx, 0.0), _w(is_die, Cndy, 0.0), _w(is_die, Cndz, 0.0)
    Cndx, Cndy, Cndz = _w(is_die, 0.0, Cndx), _w(is_die, 0.0, Cndy), _w(is_die, 0.0, Cndz)
    Cmmx, Cmmy, Cmmz = _w(is_met, Cndx, 0.0), _w(is_met, Cndy, 0.0), _w(is_met, Cndz, 0.0)
    Clx, Cly, Clz = _w(is_met, 0.0, Cndx), _w(is_met, 0.0, Cndy), _w(is_met, 0.0, Cndz)

    # dielectric: gg = g ginv, ginv = rsqrt(max(g.g, 1e-30))
    gate_g = (g2 > 1e-30).to(f32)
    dot_gc = gx * Cggx + gy * Cggy + gz * Cggz
    k_g = gate_g * ginv * ginv * ginv * dot_gc
    Cgx, Cgy, Cgz = ginv * Cggx - k_g * gx, ginv * Cggy - k_g * gy, ginv * Cggz - k_g * gz
    # g = where(refl, r, f)
    Crx, Cry, Crz = _w(refl, Cgx, 0.0), _w(refl, Cgy, 0.0), _w(refl, Cgz, 0.0)
    Cfx, Cfy, Cfz = _w(refl, 0.0, Cgx), _w(refl, 0.0, Cgy), _w(refl, 0.0, Cgz)
    # f = eta d + (eta cos_i - cos_t) on
    dot_fd = Cfx * dx + Cfy * dy + Cfz * dz
    dot_fon = Cfx * onx + Cfy * ony + Cfz * onz
    Ceta = dot_fd + cos_i * dot_fon
    Ccos_i = eta * dot_fon
    Ccos_t = -dot_fon
    Cdx, Cdy, Cdz = Cdx + eta * Cfx, Cdy + eta * Cfy, Cdz + eta * Cfz
    Conx, Cony, Conz = ecc * Cfx, ecc * Cfy, ecc * Cfz
    # cos_t = where(tir, 0, sqrt(wct)), wct = where(tir, 1, max(1 - sin2, 1e-12))
    Cs = _w(tir, 0.0, Ccos_t)
    Cw = 0.5 * Cs / sct
    Csin2 = _w(~tir & ((1.0 - sin2) > 1e-12), -Cw, 0.0)
    # sin2 = eta^2 (1 - cos_i^2)
    Ceta = Ceta + 2.0 * eta * (1.0 - cos_i * cos_i) * Csin2
    Ccos_i = Ccos_i - 2.0 * eta * eta * cos_i * Csin2
    # cos_i = where(inside, ddot, -ddot)
    Cddot = _w(inside, Ccos_i, -Ccos_i)
    # eta = where(inside, brf, 1 / max(brf, 1e-12))
    Cbrf = Cbrf + _w(inside, Ceta, _w(brf > 1e-12, -Ceta / (mbrf * mbrf), 0.0))
    # on = sgn n
    Cnx, Cny, Cnz = sgn * Conx, sgn * Cony, sgn * Conz

    # metal: mm = m minv, minv = rsqrt(max(m.m, 1e-30)); m = r + brg u
    gate_m = (m2 > 1e-30).to(f32)
    dot_mc = mx * Cmmx + my * Cmmy + mz * Cmmz
    k_m = gate_m * minv * minv * minv * dot_mc
    Cmx, Cmy, Cmz = minv * Cmmx - k_m * mx, minv * Cmmy - k_m * my, minv * Cmmz - k_m * mz
    Cbrg = ux * Cmx + uy * Cmy + uz * Cmz
    Crx, Cry, Crz = Crx + Cmx, Cry + Cmy, Crz + Cmz

    # r = d - 2 ddot n ; ddot = d.n
    Cdx, Cdy, Cdz = Cdx + Crx, Cdy + Cry, Cdz + Crz
    Cddot = Cddot - 2.0 * (nx * Crx + ny * Cry + nz * Crz)
    Cnx, Cny, Cnz = Cnx - 2.0 * ddot * Crx, Cny - 2.0 * ddot * Cry, Cnz - 2.0 * ddot * Crz
    Cdx, Cdy, Cdz = Cdx + Cddot * nx, Cdy + Cddot * ny, Cdz + Cddot * nz
    Cnx, Cny, Cnz = Cnx + Cddot * dx, Cny + Cddot * dy, Cnz + Cddot * dz

    # lambert: l = where(ldeg, n, lxr linv), linv = rsqrt(where(ldeg, 1, max(ln2, 1e-30)))
    Cnx = Cnx + _w(ldeg, Clx, 0.0)
    Cny = Cny + _w(ldeg, Cly, 0.0)
    Cnz = Cnz + _w(ldeg, Clz, 0.0)
    nld = ~ldeg
    Clxx, Clxy, Clxz = _w(nld, linv * Clx, 0.0), _w(nld, linv * Cly, 0.0), _w(nld, linv * Clz, 0.0)
    Clinv = _w(nld, lxx * Clx + lxy * Cly + lxz * Clz, 0.0)
    Cw2 = -0.5 * linv * linv * linv * Clinv
    Cln2 = _w(nld & (ln2 > 1e-30), Cw2, 0.0)
    Clxx, Clxy, Clxz = Clxx + 2.0 * Cln2 * lxx, Clxy + 2.0 * Cln2 * lxy, Clxz + 2.0 * Cln2 * lxz
    # lxr = n + u
    Cnx, Cny, Cnz = Cnx + Clxx, Cny + Clxy, Cnz + Clxz

    # n = where(ispl, pn, sn sinv): a plane normal's cotangent is dropped
    Cnx, Cny, Cnz = _w(ispl, 0.0, Cnx), _w(ispl, 0.0, Cny), _w(ispl, 0.0, Cnz)
    gate_s = (sn2 > 1e-30).to(f32)
    dot_sc = snx * Cnx + sny * Cny + snz * Cnz
    k_s = gate_s * sinv * sinv * sinv * dot_sc
    Csnx, Csny, Csnz = sinv * Cnx - k_s * snx, sinv * Cny - k_s * sny, sinv * Cnz - k_s * snz
    # sn = h - bc
    Chx, Chy, Chz = Chx + Csnx, Chy + Csny, Chz + Csnz
    Cbcx, Cbcy, Cbcz = -Csnx, -Csny, -Csnz

    # h = o + t d
    Cox, Coy, Coz = Cox + Chx, Coy + Chy, Coz + Chz
    Ct = dx * Chx + dy * Chy + dz * Chz
    Cdx, Cdy, Cdz = Cdx + t * Chx, Cdy + t * Chy, Cdz + t * Chz
    # t = where(hit, where(ispl, t_p, t_s), 0)
    Ct = _w(hit, Ct, 0.0)
    Cts = _w(ispl, 0.0, Ct)
    Ctp = _w(ispl, Ct, 0.0)

    # sphere: t_s = where(root, -bq - sq, -bq + sq), sq = sqrt(max(disc, 1e-12))
    Cbq = -Cts
    Csq = _w(root, -Cts, Cts)
    Cdisc = _w(disc > 1e-12, 0.5 * Csq / sq, 0.0)
    Cbq = Cbq + 2.0 * bq * Cdisc
    Cc0 = -Cdisc
    # c0 = oc.oc - brad^2 ; bq = oc.d ; oc = o - bc
    Cocx, Cocy, Cocz = 2.0 * Cc0 * ocx, 2.0 * Cc0 * ocy, 2.0 * Cc0 * ocz
    Cbrad = -2.0 * brad * Cc0
    Cocx, Cocy, Cocz = Cocx + Cbq * dx, Cocy + Cbq * dy, Cocz + Cbq * dz
    Cdx, Cdy, Cdz = Cdx + Cbq * ocx, Cdy + Cbq * ocy, Cdz + Cbq * ocz
    Cox, Coy, Coz = Cox + Cocx, Coy + Cocy, Coz + Cocz
    Cbcx, Cbcy, Cbcz = Cbcx - Cocx, Cbcy - Cocy, Cbcz - Cocz

    # plane: t_p = -num / safe, num = pn.o + pd, safe = where(|pn.d| > 1e-12, pn.d, 1)
    Cnum = -Ctp / safe
    Cndd = _w(nz_ok, -(Ctp * t_p) / safe, 0.0)
    Cox, Coy, Coz = Cox + Cnum * pnx, Coy + Cnum * pny, Coz + Cnum * pnz
    Cdx, Cdy, Cdz = Cdx + Cndd * pnx, Cdy + Cndd * pny, Cdz + Cndd * pnz

    slots = (Cbcx, Cbcy, Cbcz, Cbrad, Cbar, Cbag, Cbab, Cbrf, Cbrg)
    return (Cox, Coy, Coz), (Cdx, Cdy, Cdz), (Ctr, Ctg, Ctb), slots


def _raygen_parts(cam, px, py, jx, jy, inv_w, inv_h):
    r = cam[3:12]
    tan_half, aspect = cam[12], cam[13]
    nxn = 2.0 * (px + jx) * inv_w - 1.0
    nyn = 1.0 - 2.0 * (py + jy) * inv_h
    a = nxn * tan_half
    dvx = a * aspect
    dvy = nyn * tan_half
    dwx = r[0] * dvx + r[1] * dvy - r[2]
    dwy = r[3] * dvx + r[4] * dvy - r[5]
    dwz = r[6] * dvx + r[7] * dvy - r[8]
    inv = _rsqrt(dwx * dwx + dwy * dwy + dwz * dwz)
    return nxn, nyn, a, dvx, dvy, (dwx, dwy, dwz), inv


def raygen(cam, px, py, jx, jy, inv_w, inv_h):
    """Camera ray through pixel (px + jx, py + jy) (pallas_grad.py:1391-1406).
    ``cam`` is the 16-float camera vector as Python floats."""
    *_, (dwx, dwy, dwz), inv = _raygen_parts(cam, px, py, jx, jy, inv_w, inv_h)
    near = cam[14]
    o = (cam[0] + dwx * near, cam[1] + dwy * near, cam[2] + dwz * near)
    return o, (dwx * inv, dwy * inv, dwz * inv)


def raygen_adjoint(cam, px, py, jx, jy, inv_w, inv_h, co, cd):
    """Cotangents of the 15 camera floats (position, row-major rotation,
    tan(vfov/2), aspect, near) given those of the ray's origin and
    direction, per ray."""
    nxn, nyn, a, dvx, dvy, (dwx, dwy, dwz), inv = _raygen_parts(cam, px, py, jx, jy,
                                                                 inv_w, inv_h)
    r = cam[3:12]
    aspect, near = cam[13], cam[14]
    Cox, Coy, Coz = co
    Cdx, Cdy, Cdz = cd
    # d = dw inv, inv = rsqrt(dw.dw) ; o = cp + dw near
    kd = inv * inv * inv * (dwx * Cdx + dwy * Cdy + dwz * Cdz)
    Cdwx = Cox * near + (inv * Cdx - kd * dwx)
    Cdwy = Coy * near + (inv * Cdy - kd * dwy)
    Cdwz = Coz * near + (inv * Cdz - kd * dwz)
    Cnear = dwx * Cox + dwy * Coy + dwz * Coz
    # dw_i = r[3i] dvx + r[3i+1] dvy - r[3i+2]
    Cdvx = r[0] * Cdwx + r[3] * Cdwy + r[6] * Cdwz
    Cdvy = r[1] * Cdwx + r[4] * Cdwy + r[7] * Cdwz
    # dvx = (nxn tan) aspect ; dvy = nyn tan
    Ctan = Cdvx * aspect * nxn + Cdvy * nyn
    Caspect = Cdvx * a
    return [Cox, Coy, Coz,
            Cdwx * dvx, Cdwx * dvy, -Cdwx,
            Cdwy * dvx, Cdwy * dvy, -Cdwy,
            Cdwz * dvx, Cdwz * dvy, -Cdwz,
            Ctan, Caspect, Cnear]
