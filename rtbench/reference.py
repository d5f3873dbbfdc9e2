"""The plain PyTorch reference that decides ``correct``, and the live-work
counts of the roofline.

It imports numpy, torch and ``rtbench.inputs`` only: no kernel, no module
of the program.  What the program derives from the inputs (the camera's
rotation and vector, the primitive rows, the draws, the frame, the loss,
the gradient, Adam's update) is worked out here again from the same
inputs.  The arithmetic of a bounce is a frozen copy of the program's plain
versions, operation for operation in float32, so that a sound frame agrees
to the last bit wherever both take the same branch:

* the counter hash: ``rt_tpu_torch/ops/render.py:118-143`` (``_mul32``,
  ``hash_u01``);
* the chunk and sample seeds: ``ops/render.py:146-158`` (``_chunk_seeds``),
  ``ops/grad.py:89-93`` (``_sample_seeds``), ``ops/wavefront_grad.py:82-105``
  (``_wf_grad_static``, ``_train_seeds``);
* the camera: ``rt_tpu_torch/camera.py:31-68`` (``_fma32``, ``_norm3``,
  ``_cross``, ``look_rotation``) and ``ops/render.py:161-166, 588-597``
  (``_inv_size``, ``_pack_camera``);
* raygen and the bounce: ``ops/render.py:415-429`` (``_raygen_plain``) and
  ``ops/render.py:178-397`` (``_bounce_plain``: spheres, the sky, lambert
  and metal), with the sample loop of ``render_tile_plain`` (:432-545);
* the frame: ``ops/render.py:648-664`` (``_chunked_frame``); the loss and
  cotangent: ``ops/blockwise_grad.py:302-304``; the classes:
  ``rt_tpu_torch/materials.py:44``.

It covers the scenes of the benchmark's configurations: spheres only (no
planes, no boxes), the "reference" draws, the ``mg`` personality (metal
and lambert; a dielectric type shades as lambert there).  The closest hit
is taken over (ray, sphere) pairs in blocks, the first sphere of least t
winning as in the program's serial scan; a bounce runs on the live rays
only.  The gradient of the loss with respect to the albedo is worked out
in closed form: a path's radiance is its sky term times the product of
``albedo * reflectivity`` over the bounces that scattered it, so its
derivative with respect to the albedo of material m is the number of
those bounces on m times the radiance over that albedo.  ``dtype`` runs
every float operation in another precision (the control).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MIN_HIT = 0.001
BIG = 3.0e38
SPP_CHUNK = 4          # ops/render.py _SPP_CHUNK
GRAD_RAY_CAP = 1 << 23  # ops/wavefront_grad.py _GRAD_RAY_CAP
ID_MASK = (1 << 30) - 1  # ops/wavefront.py _ID_MASK
PAIRS_PER_BLOCK = 1 << 24
_M32 = 0xFFFFFFFF
# material type -> BRDF class under "mg" (rt_tpu_torch/materials.py:44): metal
# is metal, every other type lambert
MG_CLASSES = (0, 1, 0, 0, 0, 0, 0, 0)


# ---------------------------------------------------------------------------
# draws and seeds
# ---------------------------------------------------------------------------

def _mul32(u, c):
    lo = (u * (c & 0xFFFF)) & _M32
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_u01(pix: torch.Tensor, seed: int, ctr) -> torch.Tensor:
    """U[0, 1) float32 of the counter hash at (pixel, seed, counter)."""
    x = (pix * -1640531527 + seed * 97929 + (ctr * 30103 + 1)) & _M32
    u = x ^ (x >> 16)
    u = _mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = _mul32(u, 0x846CA68B)
    u = u ^ (u >> 16)
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _wrap32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def frame_chunk_seeds(seed: int, n: int) -> list[int]:
    out, s = [], seed
    for _ in range(n):
        out.append(_wrap32(s))
        s = int((s * 1103515245 + 12345) % (2**31 - 1))
    return out


def train_chunk_seeds(seed: int, n: int) -> list[int]:
    out, s = [], _wrap32(seed)
    for _ in range(n):
        out.append(s)
        s = _wrap32(s * 1103515245 + 12345)
    return out


# A draw plan: the samples of a frame or step as chunks, each a list of
# (seed, sample-in-chunk, centred) triples.  A sample's draws are the hash at
# (pixel, seed, sample-in-chunk * (2 + 4 * depth) + k); the radiance of a
# chunk is summed in sample order and the chunks in chunk order.

def frame_plan(seed: int, spp: int, n_pix: int) -> list:
    """Every forward route's draws (``_chunked_frame``): chunks of four
    samples on the LCG chain of ``seed``, sample 0 at the pixel centre."""
    ks = [min(SPP_CHUNK, spp - s) for s in range(0, spp, SPP_CHUNK)]
    return [[(cs, j, ci == 0 and j == 0) for j in range(k)]
            for ci, (cs, k) in enumerate(zip(frame_chunk_seeds(seed, len(ks)), ks))]


def per_sample_plan(seed: int, spp: int, n_pix: int) -> list:
    """The blockwise training step's draws: one-sample calls at
    ``seed * 100003 + s``, sample 0 at the centre."""
    return [[(_wrap32(seed * 100003 + s), 0, s == 0)] for s in range(spp)]


def chunked_train_plan(seed: int, spp: int, n_pix: int) -> list:
    """The wavefront training step's draws: chunks of up to four samples
    (fewer where a chunk would pass 2**23 rays) on JAX's wrapping chain."""
    k = max(1, min(SPP_CHUNK, spp))
    while n_pix * k > GRAD_RAY_CAP and k > 1:
        k -= 1
    if n_pix * k > ID_MASK:
        k = max(1, ID_MASK // n_pix)
    ks = [min(k, spp - s) for s in range(0, spp, k)]
    return [[(cs, j, ci == 0 and j == 0) for j in range(kk)]
            for ci, (cs, kk) in enumerate(zip(train_chunk_seeds(seed, len(ks)), ks))]


STEP_PLANS = {"per_sample": per_sample_plan, "chunked": chunked_train_plan}


# ---------------------------------------------------------------------------
# camera and tables
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _norm3(v):
    x2 = _fma32(v[2], v[2], _fma32(v[1], v[1], np.float32(v[0] * v[0])))
    return np.float32(math.sqrt(np.float64(x2)))


def _cross(a, b):
    def c(i, j):
        return _fma32(a[i], b[j], -np.float32(a[j] * b[i]))
    return np.asarray([c(1, 2), c(2, 0), c(0, 1)], np.float32)


def look_rotation(direction) -> np.ndarray:
    """(3, 3) float32 rotation, columns (right, up, backward)."""
    d = np.asarray(direction, np.float32)
    f = (d / _norm3(d)).astype(np.float32)
    world_up = np.asarray([0, 1, 0], np.float32)
    parallel = abs(float(np.float32(f[0] * 0 + f[1] * 1 + f[2] * 0))) > 0.999999
    ref_up = np.asarray([0, 0, 1], np.float32) if parallel else world_up
    right = _cross(f, ref_up)
    right = (right / _norm3(right)).astype(np.float32)
    up = _cross(right, f)
    return np.stack([right, up, -f], axis=1).astype(np.float32)


def camera_vector(position, direction, size, vfov, near) -> list[float]:
    """The 16 camera floats: position, row-major rotation, tan(vfov/2),
    w/h, near (float64, rounded to float32), 0."""
    w, h = size
    rot = look_rotation(direction)
    vec = np.concatenate([np.asarray(position, np.float32), rot.reshape(-1),
                          np.asarray([np.tan(vfov * 0.5), w / h, near, 0.0], np.float32)])
    return [float(x) for x in vec]


class Tables:
    """The scene's spheres and materials on ``device`` in ``dtype``; the
    albedo is the (M, 4) parameter the run trains, or the scene's own."""

    def __init__(self, arrays: dict, device, dtype=torch.float32, albedo=None):
        n, m = arrays["n_spheres"], arrays["albedo"].shape[0]
        f = dict(device=device, dtype=dtype)
        c = torch.as_tensor(arrays["center"][:n], **f)
        self.cx, self.cy, self.cz = (c[:, k].contiguous() for k in range(3))
        r = torch.as_tensor(arrays["radius"][:n], **f)
        self.rr = r * r
        self.mat = torch.as_tensor(arrays["material"][:n], device=device, dtype=torch.int64)
        types = arrays["mat_type"]
        cls = [MG_CLASSES[int(t)] for t in types]
        self.cls = torch.as_tensor(cls, device=device, dtype=torch.int64)
        alb = arrays["albedo"] if albedo is None else albedo
        self.albedo = torch.as_tensor(alb, **f)[:, :3].contiguous()
        self.refl = torch.as_tensor(arrays["reflectivity"], **f)
        self.rough = torch.as_tensor(arrays["roughness"], **f)
        self.n_mat = m
        self.dtype = dtype


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _closest(tab: Tables, o3, d3, counts):
    """The winning sphere of each ray, ``(best_t, row)``: per (ray, sphere)
    pair the serial scan's expressions in its order, the first sphere of
    least accepted t winning; ``counts["disc_pairs"]`` gains the pairs with
    disc >= 0.  The disc is taken densely over a block of pairs, the roots
    only where it is >= 0."""
    n, s_rows = o3[0].shape[0], tab.cx.shape[0]
    dev = o3[0].device
    best = torch.full((n,), BIG, dtype=tab.dtype, device=dev)
    row = torch.zeros((n,), dtype=torch.int64, device=dev)
    block = max(1, PAIRS_PER_BLOCK // max(s_rows, 1))
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(0, n if s_rows else 0, block):
        e = min(n, s + block)
        ox, oy, oz, dx, dy, dz = (t[s:e, None] for t in (*o3, *d3))
        ocx, ocy, ocz = ox - tab.cx, oy - tab.cy, oz - tab.cz
        bq = ocx * dx
        bq += ocy * dy
        bq += ocz * dz
        c0 = ocx * ocx
        c0 += ocy * ocy
        c0 += ocz * ocz
        c0 -= tab.rr
        del ocx, ocy, ocz
        disc = bq * bq
        disc -= c0
        del c0
        ray, sph = (disc >= 0.0).nonzero(as_tuple=True)
        pairs += ray.shape[0]
        bk, dk = bq[ray, sph], disc[ray, sph]
        del bq, disc
        sq = torch.sqrt(torch.clamp_min(dk, 0.0))
        t0 = -bk - sq
        t = torch.where(t0 >= MIN_HIT, t0, -bk + sq)
        ok = t >= MIN_HIT
        ray, sph, t = ray[ok], sph[ok], t[ok]
        tmin = torch.full((e - s,), BIG, dtype=tab.dtype, device=dev)
        tmin.scatter_reduce_(0, ray, t, "amin")
        win = t == tmin[ray]
        first = torch.full((e - s,), s_rows, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, ray[win], sph[win], "amin")
        best[s:e] = tmin
        row[s:e] = torch.where(first < s_rows, first, 0)
    counts["disc_pairs"] += pairs
    return best, row


def _bounce(tab: Tables, o3, d3, thr3, u3, counts):
    """One bounce of live rays (``_bounce_plain`` for a live ray): returns
    ``(missed, sky radiance, o', d', thr', alive, scattered material or
    -1)``."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    tr, tg, tb = thr3
    best, row = _closest(tab, o3, d3, counts)
    hit = best < 1e37
    mat = tab.mat[row]
    bcx, bcy, bcz = tab.cx[row], tab.cy[row], tab.cz[row]
    cls = tab.cls[mat]
    brg = tab.rough[mat]

    ts_ = 0.5 * (dy + 1.0)
    miss = ~hit
    rad = tuple(torch.where(miss, v, 0.0) for v in
                (tr * (1.0 - 0.5 * ts_), tg * (1.0 - 0.3 * ts_), tb))

    t_safe = torch.where(hit, best, 0.0)
    hx, hy, hz = ox + t_safe * dx, oy + t_safe * dy, oz + t_safe * dz
    snx, sny, snz = hx - bcx, hy - bcy, hz - bcz
    sinv = _rsqrt(torch.clamp_min(snx * snx + sny * sny + snz * snz, 1e-30))
    nx, ny, nz = snx * sinv, sny * sinv, snz * sinv

    ux, uy, uz = u3
    uinv = _rsqrt(torch.clamp_min(ux * ux + uy * uy + uz * uz, 1e-30))
    ux, uy, uz = ux * uinv, uy * uinv, uz * uinv

    lx, ly, lz = nx + ux, ny + uy, nz + uz
    ln2 = lx * lx + ly * ly + lz * lz
    ldeg = ln2 < 1e-16
    linv = _rsqrt(torch.where(ldeg, 1.0, ln2))
    ndx = torch.where(ldeg, nx, lx * linv)
    ndy = torch.where(ldeg, ny, ly * linv)
    ndz = torch.where(ldeg, nz, lz * linv)

    dd = dx * nx + dy * ny + dz * nz
    rx, ry, rz = dx - 2.0 * dd * nx, dy - 2.0 * dd * ny, dz - 2.0 * dd * nz
    mx, my, mz = rx + brg * ux, ry + brg * uy, rz + brg * uz
    mabs = (mx * nx + my * ny + mz * nz) <= 0.0
    minv = _rsqrt(torch.clamp_min(mx * mx + my * my + mz * mz, 1e-30))
    is_met = cls == 1
    ndx = torch.where(is_met, mx * minv, ndx)
    ndy = torch.where(is_met, my * minv, ndy)
    ndz = torch.where(is_met, mz * minv, ndz)

    alive = hit & ~(is_met & mabs)
    f = tab.albedo[mat] * tab.refl[mat][:, None]
    thr = (torch.where(alive, tr * f[:, 0], tr), torch.where(alive, tg * f[:, 1], tg),
           torch.where(alive, tb * f[:, 2], tb))
    o_n = tuple(torch.where(hit, a, b) for a, b in ((hx, ox), (hy, oy), (hz, oz)))
    d_n = tuple(torch.where(hit, a, b) for a, b in ((ndx, dx), (ndy, dy), (ndz, dz)))

    counts["live"] += hit.shape[0]
    counts["miss"] += miss.sum()
    counts["sphere"] += hit.sum()
    counts["metal"] += (hit & is_met).sum()
    counts["lambert"] += (hit & ~is_met).sum()
    return miss, rad, o_n, d_n, thr, alive, torch.where(alive, mat, -1)


COUNT_KEYS = ("rays", "live", "miss", "sphere", "plane", "lambert", "metal", "dielectric",
              "disc_pairs")


def new_counts() -> dict:
    return dict.fromkeys(COUNT_KEYS, 0)


def trace_sample(tab: Tables, cam, size, max_bounces, sample, pix, counts, *, keep_mats=False,
                 batch=1 << 21):
    """One sample of the rays of pixels ``pix`` (int64, on the tables'
    device): ``(radiance (P, 3), scattering materials (B, P) int8 or
    None)``; the sample is ``(seed, sample-in-chunk, centred)``."""
    seed, smp, center = sample
    w, h = size
    dt, dev = tab.dtype, pix.device
    per_sample = 2 + 4 * max_bounces
    base = smp * per_sample
    inv_w, inv_h = float(np.float32(1.0 / w)), float(np.float32(1.0 / h))
    c = cam
    r = c[3:12]
    tan_half, aspect, near = c[12], c[13], c[14]
    n = pix.shape[0]
    rad_out = torch.zeros((n, 3), dtype=dt, device=dev)
    mats_out = (torch.full((max_bounces, n), -1, dtype=torch.int8, device=dev)
                if keep_mats else None)
    counts["rays"] += n
    for s in range(0, n, batch):
        p = pix[s:s + batch]
        m = p.shape[0]
        px, py = (p % w).to(dt), (p // w).to(dt)
        if center:
            jx = jy = 0.5
        else:
            jx, jy = hash_u01(p, seed, base + 1).to(dt), hash_u01(p, seed, base + 2).to(dt)
        nx_ = 2.0 * (px + jx) * inv_w - 1.0
        ny_ = 1.0 - 2.0 * (py + jy) * inv_h
        dvx = nx_ * tan_half * aspect
        dvy = ny_ * tan_half
        dwx = r[0] * dvx + r[1] * dvy - r[2]
        dwy = r[3] * dvx + r[4] * dvy - r[5]
        dwz = r[6] * dvx + r[7] * dvy - r[8]
        o3 = (c[0] + dwx * near, c[1] + dwy * near, c[2] + dwz * near)
        inv = _rsqrt(dwx * dwx + dwy * dwy + dwz * dwz)
        d3 = (dwx * inv, dwy * inv, dwz * inv)
        one = torch.ones(m, dtype=dt, device=dev)
        thr3 = (one, one, one)
        ids = torch.arange(m, device=dev)
        for b in range(max_bounces):
            if ids.numel() == 0:
                break
            ctr = base + 2 + 4 * b
            q = p[ids]
            # the coin (counter + 4) decides only a dielectric's bounce
            u3 = tuple(hash_u01(q, seed, ctr + k).to(dt) for k in (1, 2, 3))
            missed, rad, o3, d3, thr3, alive, mat = _bounce(tab, o3, d3, thr3, u3, counts)
            rows = ids + s
            # a ray's radiance is its one sky term (the program adds zeros
            # on every other bounce)
            rad_out[rows[missed]] = torch.stack(rad, dim=1)[missed]
            if keep_mats:
                mats_out[b, rows] = mat.to(torch.int8)
            keep = alive.nonzero().squeeze(1)
            ids = ids[keep]
            o3, d3, thr3 = (tuple(v[keep] for v in g) for g in (o3, d3, thr3))
    return rad_out, mats_out


def render_sums(tab, cam, size, max_bounces, plan, pix, counts, *, keep_mats=False):
    """The plan's per-sample radiance of pixels ``pix`` and the frame sum:
    ``(sum (P, 3), per-sample radiance list, per-sample materials list)``,
    the sum in the program's order (samples within a chunk, then chunks)."""
    total, rads, mats = None, [], []
    for chunk in plan:
        acc = None
        for sample in chunk:
            rad, mt = trace_sample(tab, cam, size, max_bounces, sample, pix, counts,
                                   keep_mats=keep_mats)
            rads.append(rad)
            mats.append(mt)
            acc = rad if acc is None else acc + rad
        total = acc if total is None else total + acc
    return total, rads, mats


def frame_pixels(tab, cam, size, spp, max_bounces, seed, pix, counts=None):
    """The returned frame (gamma applied) at pixels ``pix``: (P, 3)."""
    counts = new_counts() if counts is None else counts
    total, _, _ = render_sums(tab, cam, size, max_bounces,
                              frame_plan(seed, spp, size[0] * size[1]), pix, counts)
    img = total * float(np.float32(1.0 / spp))
    return torch.sqrt(torch.clamp_min(img, 0.0))


def loss_and_grad(tab, cam, size, spp, max_bounces, plan, target, counts=None,
                  grad_pixels=None):
    """The MSE of the plan's pre-gamma frame against ``target`` (H, W, 3)
    and its gradient with respect to the (M, 3) albedo: ``(loss, grad
    float64 (M, 3))``.  ``grad_pixels``, ``(first, count)``: the only pixels
    whose terms the gradient takes (a fault's stand-in; the loss keeps
    every pixel)."""
    counts = new_counts() if counts is None else counts
    w, h = size
    n = w * h
    pix = torch.arange(n, device=target.device)
    total, rads, mats = render_sums(tab, cam, size, max_bounces, plan, pix, counts,
                                    keep_mats=True)
    diff = total * float(np.float32(1.0 / spp)) - target.reshape(n, 3).to(tab.dtype)
    loss = torch.mean(diff.double() ** 2)
    cot = (2.0 * diff.double() / (3.0 * n * spp))
    if grad_pixels is not None:
        first, count = grad_pixels
        cot[:first] = 0.0
        cot[first + count:] = 0.0
    grad = torch.zeros((tab.n_mat, 3), dtype=torch.float64, device=target.device)
    for rad, mt in zip(rads, mats):
        wgt = cot * rad.double()
        for b in range(mt.shape[0]):
            on = mt[b] >= 0
            if bool(on.any()):
                grad.index_add_(0, mt[b][on].long(), wgt[on])
    alb = tab.albedo.double()
    grad = torch.where(alb != 0.0, grad / torch.where(alb != 0.0, alb, 1.0), 0.0)
    return float(loss), grad


def adam_update(p, g, m, v, k, lr, betas=(0.9, 0.999), eps=1e-8):
    """One step of Adam (torch.optim.Adam's update) in float64, in place."""
    b1, b2 = betas
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    denom = (v / (1 - b2 ** k)).sqrt() + eps
    p.sub_(lr / (1 - b1 ** k) * m / denom)
