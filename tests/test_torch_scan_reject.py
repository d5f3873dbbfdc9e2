"""The rejecting sphere scan of the render, blockwise and blockwise record
kernels (``csrc/trace.cuh`` ``scan_spheres_rejecting``) against the serial
scan.

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

The blockwise record kernel runs the same scan and also keeps the near-root
flag of each row it takes (``row_root``'s ``kRoot``); the records' root bit
is then the serial table-row rule's: the flag of the sphere that last led
the scan (the unrolled record form, even when a box wins later), or, in the
blockwise form, the flag recomputed from an all-zero row unless a sphere
won.  :func:`test_record_root_flag_is_the_serial_rule` holds the mirror's
flag against ``ops.render._bounce_plain``'s records (the plain version of
both record kernels) on the same edge rays, on rays whose sphere a plane
ties and on rays where a box beats the sphere that led.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch.ops import _grad_math as gm
from rt_tpu_torch.ops.render import _BIG, _MIN_HIT, _bounce_plain

N_SPHERES = 64
GROUND = (0.0, -1000.5, 0.0, 1000.0)  # its top at y = -0.5


_TORCH_SQRT = torch.sqrt


def _sqrt_rn(x):
    """A correctly rounded float32 square root (float64, then rounded)."""
    return _TORCH_SQRT(x.double()).float()


def rejecting_scan(spheres, planes, o3, d3, *, behind, root0=True):
    """The kernel's scan, row by row: ``(best_t, bidx, ispl, root)`` as
    :func:`gm.scan` (``root0``: the root flag before any sphere is taken,
    True there, False in the record forms).  Planes are scanned as the
    serial scan does."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    n = ox.shape[0]
    best = torch.full_like(ox, _BIG)
    bidx = torch.zeros(n, dtype=torch.int64)
    ispl = torch.zeros(n, dtype=torch.bool)
    root = torch.full((n,), root0, dtype=torch.bool)
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


def record_scan(spheres, planes, boxes, o3, d3):
    """The blockwise record kernel's closest hit: planes and the rejecting
    sphere scan keeping the taken row's root flag, then the boxes' slab
    test with strict '<' (trace.cuh bounce_once).  Returns ``(kind, idx,
    root)`` in the records' numbering (1 sphere, 2 plane, 3 box, 0 miss),
    ``root`` being the flag of the sphere that last led."""
    best, bidx, ispl, root = rejecting_scan(spheres, planes, o3, d3, behind=False, root0=False)
    kind = torch.where(best < 1e37, torch.where(ispl, 2, 1), 0)
    ox, oy, oz = o3
    inv = [1.0 / torch.where(v.abs() > 1e-12, v, torch.full_like(v, 1e-12)) for v in d3]
    for i, (cx, cy, cz, ex, ey, ez) in enumerate(boxes[:, :6].tolist()):
        ta = [(c - e - o) * iv for c, e, o, iv in zip((cx, cy, cz), (ex, ey, ez), o3, inv)]
        tb = [(c + e - o) * iv for c, e, o, iv in zip((cx, cy, cz), (ex, ey, ez), o3, inv)]
        tmn = torch.maximum(torch.maximum(torch.minimum(ta[0], tb[0]), torch.minimum(ta[1], tb[1])),
                            torch.minimum(ta[2], tb[2]))
        tmx = torch.minimum(torch.minimum(torch.maximum(ta[0], tb[0]), torch.maximum(ta[1], tb[1])),
                            torch.maximum(ta[2], tb[2]))
        t = torch.where(tmn >= _MIN_HIT, tmn, tmx)
        ok = (tmx >= tmn) & (t >= _MIN_HIT) & (t < best)
        best = torch.where(ok, t, best)
        bidx = torch.where(ok, i, bidx)
        kind = torch.where(ok, 3, kind)
    return kind, bidx, root


def _boxes_before(rng, rows, n_boxes=16):
    """Boxes of half-size 0.1-0.3 on the line from a point 4 radii before
    a sphere's centre to it: the box_wins rays, aimed at those centres,
    cross a box before the sphere that leads the scan (or pass it)."""
    k = rng.integers(0, N_SPHERES - 1, n_boxes)
    d = _unit(rng, n_boxes)
    boxes = np.zeros((n_boxes, 12))
    boxes[:, :3] = rows[k, :3] - 2.5 * rows[k, 3:4] * d
    boxes[:, 3:6] = rng.uniform(0.1, 0.3, (n_boxes, 3))
    boxes[:, 6:] = 0.5
    return boxes, k, d


RECORD_CASES = ("random", "tangent", "on_surface", "bq_zero", "ground", "plane_ties",
                "box_wins")


@pytest.mark.parametrize("case", RECORD_CASES)
def test_record_root_flag_is_the_serial_rule(case, monkeypatch):
    """The rejecting scan's root flag (row_root with kRoot) against the
    serial table-row rule of both record forms, with kind and index."""
    rng = np.random.default_rng(100 + RECORD_CASES.index(case))
    rows = _spheres(rng)
    planes = np.zeros((0, 10))
    boxes = np.zeros((0, 12))
    if case == "plane_ties":
        rows[0, :4] = (0.0, 1.0, 0.0, 1.0)
        rows[1:, 0] += 2000.0
        planes = np.asarray([[0.0, 1.0, 0.0, 0.0] + [0.5] * 6])
        o, d = _plane_tie_rays()
    elif case == "box_wins":
        boxes, k, bd = _boxes_before(rng, rows)
        n = 20_000
        j = rng.integers(0, boxes.shape[0], n)
        d = bd[j] + rng.normal(0.0, 0.05, (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = rows[k[j], :3] - rng.uniform(4.0, 6.0, n)[:, None] * rows[k[j], 3:4] * d
    else:
        o, d, _ = _rays(case, rng, rows)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    o3 = tuple(f32(o[:, j]) for j in range(3))
    d3 = tuple(f32(d[:, j]) for j in range(3))
    monkeypatch.setattr(torch, "sqrt", _sqrt_rn)
    kind, idx, led = record_scan(f32(rows), f32(planes), f32(boxes), o3, d3)
    zb = o3[0] * d3[0] + o3[1] * d3[1] + o3[2] * d3[2]
    zdisc = zb * zb - (o3[0] * o3[0] + o3[1] * o3[1] + o3[2] * o3[2])
    zero_row = (-zb - torch.sqrt(torch.clamp_min(zdisc, 0.0))) >= _MIN_HIT
    n = o3[0].shape[0]
    one = torch.ones(n)
    u3 = tuple(f32(c) for c in _unit(rng, n).T)
    # the plain version of both record kernels (rows as the blockwise
    # tables' first 10 and 12 columns)
    plain_rows = tuple([[float(v) for v in np.float32(r)] for r in t]
                       for t in (planes, rows, boxes))
    for form, want_root in (("blockwise", torch.where(kind == 1, led, zero_row)),
                            ("unrolled", led)):
        rec = _bounce_plain(plain_rows, o3, d3, (one, one, one), one, u3, one * 0.5, False,
                            replay=form)[5]
        assert torch.equal(rec["kind"], kind.to(torch.int32)), form
        assert torch.equal(rec["idx"][kind > 0], idx[kind > 0].to(torch.int32)), form
        got = (rec["bits"] & 1) > 0
        assert torch.equal(got, want_root), f"{case} {form}: {int((got != want_root).sum())} " \
                                            "rays differ in the root flag"
    if case == "box_wins":  # boxes beat spheres that had led, with either flag
        best, _, ispl, _ = rejecting_scan(f32(rows), f32(planes), o3, d3, behind=False)
        beaten = (kind == 3) & (best < 1e37) & ~ispl
        assert beaten.sum() > 100 and led[beaten].any() and (~led[beaten]).any()
        assert (kind == 1).sum() > 100
    elif case == "plane_ties":
        assert (kind == 1).all()
    else:
        assert (kind == 1).any() and (kind == 0).any()
