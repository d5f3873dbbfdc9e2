"""The per-ray math of the fused gradient kernels (rt_tpu_torch.ops._grad_math)
against the JAX package: the hand-written bounce adjoint against
``jax.vjp(pallas_grad._bounce_smooth)`` with every decision pinned, and
against torch.autograd of the same smooth map; the raygen adjoint against
``jax.vjp`` of the JAX raygen.  No Pallas kernel runs here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.ops import pallas_grad as pg
from rt_tpu_torch.ops import _grad_math as gm
from rt_tpu_torch.ops.render import _rsqrt

N = 64  # rays per case

# (winner, material, root, ldeg, alive, refl, tir, inside); None = as the
# geometry gives it.  Every pinned-bit combination of the adjoint.
CASES = {
    "sphere_near_lambert": ("sphere", "lambert", True, False, True, None, None, None),
    "sphere_far_lambert": ("sphere", "lambert", False, False, True, None, None, None),
    "sphere_lambert_degenerate": ("sphere", "lambert", True, True, True, None, None, None),
    "plane_lambert": ("plane", "lambert", True, False, True, None, None, None),
    "plane_lambert_degenerate": ("plane", "lambert", True, True, True, None, None, None),
    "sphere_metal": ("sphere", "metal", True, False, True, None, None, None),
    "sphere_metal_absorbed": ("sphere", "metal", True, False, False, None, None, None),
    "plane_metal": ("plane", "metal", True, False, True, None, None, None),
    "sphere_dielectric_reflect": ("sphere", "dielectric", True, False, True, True, False, False),
    "sphere_dielectric_refract": ("sphere", "dielectric", True, False, True, False, False, False),
    "sphere_dielectric_inside_refract": ("sphere", "dielectric", False, False, True, False, False,
                                         True),
    "sphere_dielectric_inside_tir": ("sphere", "dielectric", False, False, True, True, True, True),
    "plane_dielectric_refract": ("plane", "dielectric", True, False, True, False, False, False),
    "miss": ("miss", "lambert", True, False, False, False, False, False),
    "not_live": ("dead", "lambert", True, False, False, False, False, False),
}


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _case(name, seed=0):
    """Primals, pinned bits and cotangents for one case: (N,) float32
    arrays drawn from a numpy seed; the geometric bits (inside, tir, metal
    absorption) agree with the primals, rays near a decision boundary are
    dropped."""
    winner, mat, root, ldeg, alive, refl, tir, inside = CASES[name]
    rng = np.random.default_rng(seed)
    m = 16384
    o = rng.uniform(-1, 1, (m, 3))
    d = _unit(rng.normal(size=(m, 3)))
    u = _unit(rng.normal(size=(m, 3)))
    bc = np.zeros((m, 3))
    brad = np.ones(m)
    pn = np.zeros((m, 3))
    pdd = np.zeros(m)
    ok = np.ones(m, bool)
    if winner == "sphere":
        if root:
            bc = o + rng.uniform(1.5, 3.0, (m, 1)) * d + 0.25 * rng.normal(size=(m, 3))
            brad = rng.uniform(0.4, 0.8, m)
        else:  # origin inside the sphere: the far root
            bc = o + 0.2 * rng.normal(size=(m, 3))
            brad = rng.uniform(0.8, 1.2, m)
        oc = o - bc
        bq = (oc * d).sum(-1)
        disc = bq * bq - ((oc * oc).sum(-1) - brad * brad)
        sq = np.sqrt(np.maximum(disc, 0))
        ok &= disc > 1e-3
        ok &= ((-bq - sq) >= 1e-2) == root
        t = np.where(root, -bq - sq, -bq + sq)
        n = _unit(o + t[:, None] * d - bc)
    elif winner == "plane":
        pn = _unit(rng.normal(size=(m, 3)))
        pdd = -(pn * (o + rng.uniform(1.0, 3.0, (m, 1)) * d)).sum(-1)
        ok &= np.abs((pn * d).sum(-1)) > 1e-2
        n = pn
    else:
        n = _unit(rng.normal(size=(m, 3)))
    ddot = (d * n).sum(-1)
    ok &= np.abs(ddot) > 1e-2
    brf = {"lambert": 0.7, "metal": 0.8, "dielectric": 1.5}[mat]
    brg = rng.uniform(0.05, 0.5, m) if alive else rng.uniform(0.8, 1.0, m)
    if mat != "metal":
        brg = np.zeros(m)
    if ldeg:
        u = -n
    geo_inside = ddot > 0
    if mat == "dielectric":
        eta = np.where(geo_inside, brf, 1 / brf)
        cos_i = np.where(geo_inside, ddot, -ddot)
        sin2 = eta * eta * (1 - cos_i * cos_i)
        ok &= (geo_inside == inside) & ((sin2 > 1) == tir) & (np.abs(sin2 - 1) > 1e-2)
    if mat == "metal":
        r = d - 2 * ddot[:, None] * n
        mm = r + brg[:, None] * u
        mdot = (mm * n).sum(-1)
        ok &= (mdot > 0) == alive
        ok &= np.abs(mdot) > 1e-2
    sel = np.flatnonzero(ok)[:N]
    assert sel.size == N, (name, sel.size)

    f32 = lambda a: np.asarray(a, np.float64)[sel].astype(np.float32)
    pay = [f32(bc[:, 0]), f32(bc[:, 1]), f32(bc[:, 2]), f32(brad),
           f32(pn[:, 0]), f32(pn[:, 1]), f32(pn[:, 2]), f32(pdd),
           f32(rng.uniform(0.2, 0.9, m)), f32(rng.uniform(0.2, 0.9, m)),
           f32(rng.uniform(0.2, 0.9, m)), f32(np.full(m, brf)), f32(brg)]
    hit = winner in ("sphere", "plane")
    full = lambda v: np.full(N, bool(v))
    bits = dict(hit=full(hit), live_h=full(hit), miss=full(winner == "miss"),
                alive=full(hit and alive), ispl=full(winner == "plane"), root=full(root),
                ldeg=full(ldeg), refl=full(refl), tir=full(tir), inside=full(inside),
                is_met=full(mat == "metal"), is_die=full(mat == "dielectric"))
    prim = dict(o=[f32(o[:, k]) for k in range(3)], d=[f32(d[:, k]) for k in range(3)],
                thr=[f32(rng.uniform(0.2, 1.0, m)) for _ in range(3)],
                u=[f32(u[:, k]) for k in range(3)], pay=pay)
    cots = [[f32(rng.normal(size=m)) for _ in range(3)] for _ in range(4)]
    return prim, bits, cots


def _spec(name, minimal):
    """has_* flags of the JAX specialisation: all classes present, or only
    the case's own."""
    if not minimal:
        return dict(has_met=True, has_die=True, has_planes=True, has_spheres=True)
    winner, mat = CASES[name][:2]
    return dict(has_met=mat == "metal", has_die=mat == "dielectric",
                has_planes=winner == "plane", has_spheres=winner != "plane")


def _jax_adjoint(prim, bits, cots, spec):
    jbits = {("refl_bit" if k == "refl" else k): jnp.asarray(v) for k, v in bits.items()}
    jbits["mabs"] = jnp.zeros(N, bool)
    u3 = tuple(jnp.asarray(v) for v in prim["u"])

    def f(o3, d3, thr3, pay):
        return pg._bounce_smooth(o3, d3, thr3, pay, u3, jbits, **spec)

    args = [tuple(jnp.asarray(v) for v in prim[k]) for k in ("o", "d", "thr", "pay")]
    _, vjp = jax.vjp(f, *args)
    co, cd, ct, pay_cot = vjp(tuple(tuple(jnp.asarray(v) for v in c) for c in cots))
    slots = [pay_cot[k] for k in (0, 1, 2, 3, 8, 9, 10, 11, 12)]
    return [np.stack([np.asarray(v) for v in g]) for g in (co, cd, ct, slots)]


def _torch_adjoint(prim, bits, cots):
    t = lambda vs: tuple(torch.from_numpy(v) for v in vs)
    tb = {k: torch.from_numpy(v) for k, v in bits.items()}
    co, cd, ct, slots = gm.bounce_adjoint(t(prim["o"]), t(prim["d"]), t(prim["thr"]),
                                          t(prim["pay"]), t(prim["u"]), tb, *(t(c) for c in cots))
    return [torch.stack(g).numpy() for g in (co, cd, ct, slots)]


def _assert_close(got, want, what):
    # float32 rounding: the two transposes evaluate the same sums in a
    # different order, so each entry agrees to rtol 1e-4, and entries that
    # cancel to near zero to 1e-5 of the largest entry of that output
    for name, g, w in zip(("o", "d", "thr", "slots"), got, want):
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("minimal", [False, True], ids=["full", "specialised"])
@pytest.mark.parametrize("name", list(CASES))
def test_adjoint_matches_jax_vjp(name, minimal):
    prim, bits, cots = _case(name)
    want = _jax_adjoint(prim, bits, cots, _spec(name, minimal))
    got = _torch_adjoint(prim, bits, cots)
    _assert_close(got, want, name)
    if bits["ispl"][0]:
        # a plane's own slots hold only the material (no sphere geometry)
        assert not got[3][:4].any()
    if not bits["live_h"][0]:
        # a ray that did not hit while live passes its cotangents through
        # (the sky term aside) and feeds no primitive
        assert not got[3].any()


def _smooth_torch(o3, d3, thr3, pay, u3, bits):
    """pallas_grad._bounce_smooth in torch (all classes present), for
    torch.autograd."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    tr, tg, tb = thr3
    bcx, bcy, bcz, brad, pnx, pny, pnz, pdd, bar, bag, bab, brf, brg = pay
    ux, uy, uz = u3
    w = torch.where
    ocx, ocy, ocz = ox - bcx, oy - bcy, oz - bcz
    bq = ocx * dx + ocy * dy + ocz * dz
    disc = bq * bq - (ocx * ocx + ocy * ocy + ocz * ocz - brad * brad)
    sq = torch.sqrt(torch.clamp_min(disc, 1e-12))
    t_s = w(bits["root"], -bq - sq, -bq + sq)
    ndd = pnx * dx + pny * dy + pnz * dz
    safe = w(ndd.abs() > 1e-12, ndd, torch.ones_like(ndd))
    t_p = -(pnx * ox + pny * oy + pnz * oz + pdd) / safe
    t = w(bits["hit"], w(bits["ispl"], t_p, t_s), torch.zeros_like(t_s))
    hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
    snx, sny, snz = hx - bcx, hy - bcy, hz - bcz
    sinv = _rsqrt(torch.clamp_min(snx * snx + sny * sny + snz * snz, 1e-30))
    nx = w(bits["ispl"], pnx, snx * sinv)
    ny = w(bits["ispl"], pny, sny * sinv)
    nz = w(bits["ispl"], pnz, snz * sinv)
    ts = 0.5 * (dy + 1.0)
    mf = bits["miss"].float()
    rad = (mf * tr * (1.0 - 0.5 * ts), mf * tg * (1.0 - 0.3 * ts), mf * tb)
    lx, ly, lz = nx + ux, ny + uy, nz + uz
    ln2 = lx * lx + ly * ly + lz * lz
    ldeg = bits["ldeg"]
    linv = _rsqrt(w(ldeg, torch.ones_like(ln2), torch.clamp_min(ln2, 1e-30)))
    nd = [w(ldeg, nx, lx * linv), w(ldeg, ny, ly * linv), w(ldeg, nz, lz * linv)]
    ddot = dx * nx + dy * ny + dz * nz
    r = [dx - 2.0 * ddot * nx, dy - 2.0 * ddot * ny, dz - 2.0 * ddot * nz]
    mm = [r[0] + brg * ux, r[1] + brg * uy, r[2] + brg * uz]
    minv = _rsqrt(torch.clamp_min(mm[0] * mm[0] + mm[1] * mm[1] + mm[2] * mm[2], 1e-30))
    nd = [w(bits["is_met"], mm[k] * minv, nd[k]) for k in range(3)]
    inside = bits["inside"]
    sgn = w(inside, -1.0, 1.0)
    on = [sgn * nx, sgn * ny, sgn * nz]
    eta = w(inside, brf, 1.0 / torch.clamp_min(brf, 1e-12))
    cos_i = w(inside, ddot, -ddot)
    sin2 = eta * eta * (1.0 - cos_i * cos_i)
    tir = bits["tir"]
    cos_t = torch.sqrt(w(tir, torch.ones_like(sin2), torch.clamp_min(1.0 - sin2, 1e-12)))
    cos_t = w(tir, torch.zeros_like(cos_t), cos_t)
    f = [eta * dv + (eta * cos_i - cos_t) * onv for dv, onv in zip((dx, dy, dz), on)]
    g = [w(bits["refl"], r[k], f[k]) for k in range(3)]
    ginv = _rsqrt(torch.clamp_min(g[0] * g[0] + g[1] * g[1] + g[2] * g[2], 1e-30))
    nd = [w(bits["is_die"], g[k] * ginv, nd[k]) for k in range(3)]
    af = bits["alive"].float()
    thr_n = (tr * (1.0 - af + af * bar * brf), tg * (1.0 - af + af * bag * brf),
             tb * (1.0 - af + af * bab * brf))
    lh = bits["live_h"].float()
    o_n = (ox + lh * (hx - ox), oy + lh * (hy - oy), oz + lh * (hz - oz))
    d_n = tuple(dv + lh * (ndv - dv) for dv, ndv in zip((dx, dy, dz), nd))
    return o_n, d_n, thr_n, rad


@pytest.mark.parametrize("name", ["sphere_far_lambert", "plane_lambert", "sphere_metal",
                                  "sphere_dielectric_inside_refract", "plane_dielectric_refract",
                                  "miss"])
def test_adjoint_matches_torch_autograd(name):
    prim, bits, cots = _case(name, seed=1)
    tb = {k: torch.from_numpy(v) for k, v in bits.items()}
    leaves = {k: [torch.from_numpy(v).requires_grad_() for v in prim[k]]
              for k in ("o", "d", "thr", "pay")}
    u3 = [torch.from_numpy(v) for v in prim["u"]]
    outs = _smooth_torch(*(leaves[k] for k in ("o", "d", "thr", "pay")), u3, tb)
    total = sum((o * torch.from_numpy(c)).sum()
                for grp, cgrp in zip(outs, cots) for o, c in zip(grp, cgrp))
    total.backward()
    want = [np.stack([v.grad.numpy() for v in leaves[k]]) for k in ("o", "d", "thr")]
    want.append(np.stack([leaves["pay"][k].grad.numpy() for k in (0, 1, 2, 3, 8, 9, 10, 11, 12)]))
    _assert_close(_torch_adjoint(prim, bits, cots), want, name)


@pytest.mark.parametrize("center", [True, False])
def test_raygen_adjoint_matches_jax_vjp(center):
    rng = np.random.default_rng(3)
    w, h = 16, 12
    n = w * h
    px = np.tile(np.arange(w, dtype=np.float32), h)
    py = np.repeat(np.arange(h, dtype=np.float32), w)
    jx, jy = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    if center:
        jx = jy = np.float32(0.5)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    cam = np.concatenate([rng.normal(size=3), rot.reshape(-1),
                          [np.tan(np.pi / 8), w / h, 0.01, 0.0]]).astype(np.float32)
    inv_w, inv_h = float(np.float32(1 / w)), float(np.float32(1 / h))
    cots = [rng.normal(size=n).astype(np.float32) for _ in range(6)]

    def raygen(cam_v):  # pallas_grad.py:1391-1406
        r = cam_v[3:12]
        nx_ = 2.0 * (px + jx) * np.float32(inv_w) - 1.0
        ny_ = 1.0 - 2.0 * (py + jy) * np.float32(inv_h)
        dvx = nx_ * cam_v[12] * cam_v[13]
        dvy = ny_ * cam_v[12]
        dwx = r[0] * dvx + r[1] * dvy - r[2]
        dwy = r[3] * dvx + r[4] * dvy - r[5]
        dwz = r[6] * dvx + r[7] * dvy - r[8]
        inv = jax.lax.rsqrt(dwx * dwx + dwy * dwy + dwz * dwz)
        return (cam_v[0] + dwx * cam_v[14], cam_v[1] + dwy * cam_v[14],
                cam_v[2] + dwz * cam_v[14], dwx * inv, dwy * inv, dwz * inv)

    jcam = tuple(jnp.float32(v) for v in cam[:15])
    rays, vjp = jax.vjp(raygen, jcam)
    (want,) = vjp(tuple(jnp.asarray(c) for c in cots))
    want = np.asarray(want)

    c = cam.tolist()
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    tjx = 0.5 if center else torch.from_numpy(jx)
    tjy = 0.5 if center else torch.from_numpy(jy)
    o3, d3 = gm.raygen(c, tpx, tpy, tjx, tjy, inv_w, inv_h)
    for got_r, want_r in zip(o3 + d3, rays):
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=1e-6, atol=1e-6)
    tc = [torch.from_numpy(v) for v in cots]
    per_ray = torch.stack(gm.raygen_adjoint(c, tpx, tpy, tjx, tjy, inv_w, inv_h, tc[:3], tc[3:]))
    got = per_ray.sum(dim=1).numpy()
    # sums over 192 rays in another order: 1e-5 of the sum of magnitudes
    l1 = per_ray.abs().sum(dim=1).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * l1 + 1e-7), (got, want)
