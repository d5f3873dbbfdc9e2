"""The rejecting sphere scan of the render and blockwise kernels
(``csrc/trace.cuh`` ``scan_spheres_rejecting``) against the serial scan.

A float32 torch mirror of the kernel's row test: compact rows (cx, cy, cz,
rr) with rr the float32 product r * r; per row ``ocx .. disc`` for every
ray with the serial scan's expressions, and the square root, the roots,
the select and the tie rules, in row order, only for the rays that pass
the reject (disc >= 0; in the ``behind`` form, measured as a variant and
not taken, not bq > 0 and c0 > 0 as well).  The kernel tests the rows of
a group before one branch into their root work; for one ray that branch
is taken whenever one of its rows passes, so per ray the grouped scan is
this row-by-row one.  It must give
:func:`rt_tpu_torch.ops._grad_math.scan`'s winner bit for bit (best, row,
plane flag, root flag); the other tests hold that scan against the JAX
package.  The square root is correctly rounded in both, as the card's
``sqrtf`` is (torch's CPU float32 sqrt is not).  The rays: random rays
through 64 spheres, and rays built to sit on the reject's edges: tangent
to a sphere (disc within a few ulps of 0), starting on a sphere's surface
(c0 near 0), perpendicular to the offset (bq near 0), along the
radius-1000 ground sphere, and on duplicated rows and sphere-plane ties.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch.ops import _grad_math as gm
from rt_tpu_torch.ops.render import _BIG, _MIN_HIT

N_SPHERES = 64
GROUND = (0.0, -1000.5, 0.0, 1000.0)  # its top at y = -0.5


_TORCH_SQRT = torch.sqrt


def _sqrt_rn(x):
    """A correctly rounded float32 square root (float64, then rounded)."""
    return _TORCH_SQRT(x.double()).float()


def rejecting_scan(spheres, planes, o3, d3, *, behind):
    """The kernel's scan, row by row: ``(best_t, bidx, ispl, root)`` as
    :func:`gm.scan`.  Planes are scanned as the serial scan does."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    n = ox.shape[0]
    best = torch.full_like(ox, _BIG)
    bidx = torch.zeros(n, dtype=torch.int64)
    ispl = torch.zeros(n, dtype=torch.bool)
    root = torch.ones(n, dtype=torch.bool)
    for p, (pnx, pny, pnz, pdd) in enumerate(planes[:, :4].tolist()):
        nd = pnx * dx + pny * dy + pnz * dz
        no = pnx * ox + pny * oy + pnz * oz + pdd
        nz_ok = nd.abs() > 1e-12
        t = -no / torch.where(nz_ok, nd, torch.ones_like(nd))
        ok = nz_ok & (t >= _MIN_HIT) & (t < best)
        best = torch.where(ok, t, best)
        bidx = torch.where(ok, p, bidx)
        ispl = ispl | ok
    geo = spheres[:, :4].clone()
    geo[:, 3] = spheres[:, 3] * spheres[:, 3]  # the compact rows' rr
    for i in range(geo.shape[0]):
        cx, cy, cz, rr = geo[i]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        bq = ocx * dx + ocy * dy + ocz * dz
        c0 = ocx * ocx + ocy * ocy + ocz * ocz - rr
        disc = bq * bq - c0
        passed = disc >= 0.0
        if behind:
            passed &= ~((bq > 0.0) & (c0 > 0.0))
        k = passed.nonzero().squeeze(1)  # only these rays compute the root
        if k.numel() == 0:
            continue
        sq = torch.sqrt(disc[k])
        t0 = -bq[k] - sq
        t1 = -bq[k] + sq
        near = t0 >= _MIN_HIT
        t = torch.where(near, t0, t1)
        ok = (t >= _MIN_HIT) & ((t < best[k]) | ((t == best[k]) & ispl[k]))
        kk = k[ok]
        best[kk] = t[ok]
        bidx[kk] = i
        ispl[kk] = False
        root[kk] = near[ok]
    return best, bidx, ispl, root


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _spheres(rng):
    """64 rows: random spheres, rows 10-11 and 40 repeating rows 9 and 5
    (exact ties), and the ground sphere last."""
    rows = np.empty((N_SPHERES, 10))
    rows[:, :3] = rng.uniform(-3.0, 3.0, (N_SPHERES, 3))
    rows[:, 3] = rng.uniform(0.2, 0.8, N_SPHERES)
    rows[:, 4:] = 0.5
    rows[10] = rows[11] = rows[9]
    rows[40] = rows[5]
    rows[-1, :4] = GROUND
    return rows


def _rays(case, rng, rows):
    """(origins, directions, the row each ray was built on) of one case,
    float64 before rounding."""
    c, r = rows[:, :3], rows[:, 3]
    if case == "random":
        n = 100_000
        return rng.uniform(-4.0, 4.0, (n, 3)), _unit(rng, n), None
    n = 20_000
    k = rng.integers(0, N_SPHERES, n)
    cc, rk = c[k], r[k]
    d = _unit(rng, n)
    # a unit vector perpendicular to each direction
    perp = np.cross(d, _unit(rng, n))
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    if case == "tangent":  # the line at distance r from the centre
        o = cc + rk[:, None] * perp - rng.uniform(0.5, 5.0, n)[:, None] * d
    elif case == "on_surface":  # c0 near 0, directions out, in and along
        o = cc + rk[:, None] * _unit(rng, n)
    elif case == "bq_zero":  # the offset perpendicular to the direction
        o = cc + rng.uniform(0.0, 2.0, n)[:, None] * rk[:, None] * perp
    elif case == "ground":  # near the ground sphere's top, often grazing it
        o = np.stack([rng.uniform(-5, 5, n), -0.5 + rng.uniform(-1e-3, 1e-3, n),
                      rng.uniform(-5, 5, n)], axis=1)
        d[: n // 2, 1] = rng.uniform(-1e-3, 1e-3, n // 2)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif case == "ties":  # straight at the duplicated rows' centres
        k = rng.choice([5, 9, 10, 11, 40], n)
        o = c[k] - rng.uniform(1.0, 6.0, n)[:, None] * d
    else:
        raise ValueError(case)
    return o, d, k


def _plane_tie_rays():
    """Vertical rays up from below the plane y = 0 at x = z = 0: at t = h
    they meet the plane and the near root of the unit sphere resting on it
    (centre (0, 1, 0)), exactly: the sphere wins the tie."""
    h = np.repeat(np.asarray([5.0, 3.0, 2.5, 7.0, 1.5]), 4)
    o = np.stack([np.zeros_like(h), -h, np.zeros_like(h)], axis=1)
    d = np.tile([0.0, 1.0, 0.0], (h.size, 1))
    return o, d


CASES = ("random", "tangent", "on_surface", "bq_zero", "ground", "ties", "plane_ties")
# the edge cases: the value each sits on, and how close to 0 (float32
# rounding of terms up to ~30)
EDGES = {"tangent": ("disc", 1e-5), "on_surface": ("c0", 1e-5), "bq_zero": ("bq", 1e-5)}


@pytest.mark.parametrize("behind", [False, True], ids=["disc", "disc_behind"])
@pytest.mark.parametrize("case", CASES)
def test_rejecting_scan_is_the_serial_scan(case, behind, monkeypatch):
    rng = np.random.default_rng(CASES.index(case))
    rows = _spheres(rng)
    planes = torch.zeros((0, 10), dtype=torch.float32)
    if case == "plane_ties":
        rows[0, :4] = (0.0, 1.0, 0.0, 1.0)
        rows[1:, 0] += 2000.0  # nothing else on the rays' line
        planes = torch.tensor([[0.0, 1.0, 0.0, 0.0] + [0.5] * 6], dtype=torch.float32)
        o, d = _plane_tie_rays()
    else:
        o, d, own = _rays(case, rng, rows)
    spheres = torch.from_numpy(rows.astype(np.float32))
    o3 = tuple(torch.from_numpy(np.ascontiguousarray(o[:, j], np.float32)) for j in range(3))
    d3 = tuple(torch.from_numpy(np.ascontiguousarray(d[:, j], np.float32)) for j in range(3))
    monkeypatch.setattr(torch, "sqrt", _sqrt_rn)
    want = gm.scan(spheres, planes, o3, d3)
    got = rejecting_scan(spheres, planes, o3, d3, behind=behind)
    for name, g, w in zip(("best", "row", "plane flag", "root flag"), got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), f"{case}: {int((g != w).sum())} rays differ in {name}"

    hit = want[0] < 1e37
    if case == "plane_ties":  # the sphere won every exact tie
        assert hit.all() and not want[2].any() and (want[1] == 0).all()
        assert torch.equal(want[0], torch.from_numpy(-o[:, 1].astype(np.float32)))
    elif case == "ties":  # the first of the equal rows wins
        assert hit.any() and not (want[1][hit] == 10).any() and not (want[1][hit] == 11).any()
        assert not (want[1][hit] == 40).any()
    else:
        assert hit.any() and (~hit).any()
    if case in EDGES:
        # the inputs sit where they claim, against each ray's own sphere
        geo = spheres[torch.from_numpy(own), :4]
        ocx, ocy, ocz = (o3[j] - geo[:, j] for j in range(3))
        bq = ocx * d3[0] + ocy * d3[1] + ocz * d3[2]
        c0 = ocx * ocx + ocy * ocy + ocz * ocz - geo[:, 3] * geo[:, 3]
        disc = bq * bq - c0
        value, tol = EDGES[case]
        v = {"disc": disc, "c0": c0, "bq": bq}[value]
        edge = v.abs() < tol
        assert edge.float().mean() > 0.9 and (v[edge] >= 0).any() and (v[edge] < 0).any()
