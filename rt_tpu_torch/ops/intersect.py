"""Ray-primitive intersection on torch tensors (port of
``rt_tpu.ops.intersect``).

Semantics mirror the reference renderers' linear closest-hit scans
(mg_ray_tracer.cpp:36-102):

* ``MIN_HIT_DIST = 0.001`` epsilon (mg_ray_tracer.cpp:20).
* Within a primitive class the earliest index wins distance ties
  (``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does).
* Across classes the path tracers' ``select()`` chain lets spheres beat
  planes and boxes at equal distance; ``tie_order="rasterizer"`` keeps the
  preview's single planes → boxes → spheres scan with strict '<'.
* Boxes never hit in the path tracers (``test_boxes`` is a stub,
  mg_ray_tracer.cpp:89-93) unless ``include_boxes``; the rasterizer tests
  them with its never-assigned 'up' normal (``box_normals_up``).

:func:`closest_hit` is the jnp-style integrator's scan over (rays x
primitives) matrices.  The JAX package extracts each winner with a one-hot
contraction, chosen for the TPU's matrix unit; here ``argmin`` and a gather
fetch the same values, and the gathers of float tables (:func:`gather_rows`)
add their gradients in float64.  The square roots are taken in float64 and
rounded once (:func:`sqrt_rn`): torch's float32 CPU sqrt is not correctly
rounded and the card's is, so the CPU and the card take the same roots.
Every guard of the JAX version is kept (``_BIG``, the square root guarded on
both branches, the miss lanes' t clipped before a multiply), so that no
masked-out lane feeds a non-finite value into the backward pass; the box
normal, piecewise constant, is computed detached.

The helpers that the replay and the kernels' plain versions share round as
the kernels do (``csrc/trace.cuh`` with --fmad=false): :func:`dot3` is
x0*y0 + x1*y1 + x2*y2 in that order and :func:`safe_normalize` multiplies
by 1/sqrt (the kernels' ``rsqrt_rn``; torch's rsqrt on the card is not
correctly rounded).  A ray that grazes a sphere has a gradient of order
1/sqrt(discriminant), so the records route's bit-for-bit retrace on the
card depends on them.  :func:`gather_rows` sums its gradient in float64:
float32 adds of a million rays into one table row lose the gradient's low
digits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["HitRecord", "MIN_HIT_DIST", "closest_hit", "dot3", "gather_rows", "hit_boxes",
           "hit_planes", "hit_spheres", "safe_normalize", "sphere_stage", "sqrt_rn"]

MIN_HIT_DIST = 0.001
_BIG = 3.0e38


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b over a last axis of length 3, summed in the kernels' order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def safe_normalize(v: torch.Tensor, *, eps: float = 1e-20, fallback=None) -> torch.Tensor:
    """Normalize over the last axis (length 3) with NaN-free gradients: the
    norm is taken of a guarded squared length, so the backward of the
    square root never sees 0, and vectors with squared length <= ``eps``
    map to ``fallback`` (default: zero)."""
    n2 = dot3(v, v)[..., None]
    ok = n2 > eps
    inv = 1.0 / torch.sqrt(torch.where(ok, n2, 1.0))
    return torch.where(ok, v * inv, 0.0 if fallback is None else fallback)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, dtype=torch.float64, device=grad.device)
        return acc.index_add_(0, idx, grad.double()).to(grad.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer index tensor, whose gradient adds into
    the table's rows in float64."""
    return _GatherRows.apply(table, idx.long())


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once: taken in float64 (exact to well
    past float32's precision) and rounded to float32, on the CPU as on the
    card."""
    return torch.sqrt(x.double()).float()


class HitRecord(NamedTuple):
    """Closest-hit result for a batch of rays."""

    t: torch.Tensor         # (N,) f32 distance; _BIG where no hit
    normal: torch.Tensor    # (N, 3) f32
    material: torch.Tensor  # (N,) int32
    hit: torch.Tensor       # (N,) bool
    kind: torch.Tensor      # (N,) int32: 0 miss, 1 sphere, 2 plane, 3 box
    idx: torch.Tensor       # (N,) int32 winner index within its class
    root_lo: torch.Tensor   # (N,) bool: the sphere hit took the near root


def _count_mask(n_padded: int, count: int, device) -> torch.Tensor:
    """Validity mask of a padded table's rows."""
    return torch.arange(n_padded, device=device) < count


def _select_min(t: torch.Tensor):
    """(t_best, idx) of an (N, S) candidate matrix: the first minimum of
    each row and its index (int64)."""
    idx = torch.argmin(t, dim=-1)
    return t.gather(-1, idx[:, None])[:, 0], idx


def sphere_t_matrix(origins, dirs, centers, radii, count, *, min_dist=MIN_HIT_DIST):
    """((N, S) per-pair hit distances, _BIG where no valid hit; (N, S) near
    root taken).  With a unit direction: oc = o - c, b = oc·d, c0 = |oc|^2 -
    r^2, disc = b^2 - c0, roots -b ∓ sqrt(disc)."""
    oc = origins[:, None, :] - centers[None, :, :]
    b = dot3(oc, dirs[:, None, :])
    c0 = dot3(oc, oc) - (radii * radii)[None, :]
    disc = b * b - c0
    pos = disc > 0.0
    # guarded on both branches: the backward of sqrt at 0 is inf and would
    # leak NaN through the miss lanes' where()
    sq = torch.where(pos, sqrt_rn(torch.where(pos, disc, 1.0)), 0.0)
    t0 = -b - sq
    t1 = -b + sq
    root_lo = t0 >= min_dist
    t = torch.where(root_lo, t0, t1)
    valid = (disc >= 0.0) & (t >= min_dist) & _count_mask(centers.shape[0], count, t.device)
    return torch.where(valid, t, _BIG), root_lo


def hit_spheres(origins, dirs, centers, radii, count, *, min_dist=MIN_HIT_DIST):
    """Per-ray nearest sphere: (t, index), t = _BIG on a miss."""
    t, _ = sphere_t_matrix(origins, dirs, centers, radii, count, min_dist=min_dist)
    return _select_min(t)


def plane_t_matrix(origins, dirs, normals, ds, count, *, min_dist=MIN_HIT_DIST):
    """(N, P) per-pair plane hit distances (double-sided): n·x + d = 0 →
    t = -(n·o + d) / (n·dir).  Written as products and sums, not a matrix
    product, so no TF32 can reach it on the card."""
    ndotd = dot3(dirs[:, None, :], normals[None, :, :])
    ndoto = dot3(origins[:, None, :], normals[None, :, :]) + ds[None, :]
    ok = torch.abs(ndotd) > 1e-12
    t = -ndoto / torch.where(ok, ndotd, 1.0)
    valid = ok & (t >= min_dist) & _count_mask(normals.shape[0], count, t.device)
    return torch.where(valid, t, _BIG)


def hit_planes(origins, dirs, normals, ds, count, *, min_dist=MIN_HIT_DIST):
    """Per-ray nearest plane: (t, index), t = _BIG on a miss."""
    return _select_min(plane_t_matrix(origins, dirs, normals, ds, count, min_dist=min_dist))


def hit_boxes(origins, dirs, centers, extents, count, *, min_dist=MIN_HIT_DIST):
    """Per-ray nearest axis-aligned box by the slab test: (t, index).
    ``extents`` are half-extents; a ray starting inside a box hits its exit
    face."""
    inv = 1.0 / torch.where(torch.abs(dirs) > 1e-12, dirs, 1e-12)
    lo = (centers - extents)[None, :, :]
    hi = (centers + extents)[None, :, :]
    ta = (lo - origins[:, None, :]) * inv[:, None, :]
    tb = (hi - origins[:, None, :]) * inv[:, None, :]
    # amax/amin share the gradient among tied entries, as jnp.max does
    tmin = torch.amax(torch.minimum(ta, tb), dim=-1)
    tmax = torch.amin(torch.maximum(ta, tb), dim=-1)
    t = torch.where(tmin >= min_dist, tmin, tmax)
    valid = (tmax >= tmin) & (t >= min_dist) & _count_mask(centers.shape[0], count, t.device)
    return _select_min(torch.where(valid, t, _BIG))


@torch.no_grad()
def _box_normal(origins, dirs, t, centers, extents, idx):
    """Outward normal of the slab face hit at t: the sign of the dominant
    component of the local hit position, scaled by the extents.  Piecewise
    constant in every input, so computed without a graph (in the JAX
    package its derivative is a symbolic zero)."""
    c = centers[idx]
    e = torch.clamp_min(extents[idx], 1e-12)
    local = (origins + t[:, None] * dirs - c) / e
    ax = torch.argmax(torch.abs(local), dim=-1, keepdim=True)
    # one-hot times the sign, as the JAX version (its zeros keep the sign)
    return torch.nn.functional.one_hot(ax[:, 0], 3).to(local.dtype) * torch.sign(
        local.gather(-1, ax))


def sphere_stage(spheres, origins, dirs, *, min_dist: float = MIN_HIT_DIST):
    """Nearest-sphere stage: (t, normal, material, idx, root_lo) per ray."""
    t, root_lo_m = sphere_t_matrix(origins, dirs, spheres.center, spheres.radius,
                                   spheres.count, min_dist=min_dist)
    ts, idx = _select_min(t)
    # clip the miss lanes' t (_BIG) before the multiply: an overflow upstream
    # of a where() still poisons gradients
    hit_p = origins + torch.clamp_max(ts, 1e30)[:, None] * dirs
    n = safe_normalize(hit_p - gather_rows(spheres.center, idx))
    root_lo = root_lo_m.gather(-1, idx[:, None])[:, 0]
    return ts, n, spheres.material[idx], idx.to(torch.int32), root_lo


def closest_hit(spheres, planes, boxes, origins, dirs, *, min_dist: float = MIN_HIT_DIST,
                include_boxes: bool = False, box_normals_up: bool = False, sphere_result=None,
                tie_order: str = "tracer") -> HitRecord:
    """Closest hit over the whole scene for a flat (N, 3) ray batch (unit
    directions).

    ``include_boxes``: False reproduces the path tracers' box stub, True
    tests boxes.  ``box_normals_up``: the rasterizer's never-assigned box
    normal (stays 'up', rasterizer.cpp:38,55-58).  ``tie_order``: "tracer"
    is the path tracers' ``select()`` chain (spheres win a tie,
    mg_ray_tracer.cpp:95-102, 160-162), "rasterizer" the preview's planes →
    boxes → spheres scan with strict '<' (rasterizer.cpp:41-63).
    ``sphere_result`` replaces the sphere stage's output."""
    n = origins.shape[0]
    dev = origins.device
    if sphere_result is None:
        sphere_result = sphere_stage(spheres, origins, dirs, min_dist=min_dist)
    ts, sphere_n, sphere_m, sphere_i, root_lo = sphere_result
    tp, ip = hit_planes(origins, dirs, planes.normal, planes.d, planes.count, min_dist=min_dist)

    use_boxes = include_boxes and boxes.count > 0
    if use_boxes:
        tb, ib = hit_boxes(origins, dirs, boxes.center, boxes.extents, boxes.count,
                           min_dist=min_dist)
    else:
        tb = torch.full((n,), _BIG, device=dev)
        ib = torch.zeros((n,), dtype=torch.int64, device=dev)

    if tie_order == "rasterizer":
        # planes → boxes → spheres, strict '<': the earlier class keeps a tie
        box_over_p = tb < tp
        t_pb = torch.where(box_over_p, tb, tp)
        sphere_sel = ts < t_pb
        box_sel = box_over_p & ~sphere_sel
        t = torch.where(sphere_sel, ts, t_pb)
    else:
        # select(a=spheres, b=planes): a wins ties; boxes beat planes at a
        # tie but lose to spheres
        sphere_wins = ts <= tp
        t_sp = torch.where(sphere_wins, ts, tp)
        box_sel = tb < t_sp
        sphere_sel = sphere_wins & ~box_sel
        t = torch.where(box_sel, tb, t_sp)
    hit = t < _BIG

    normal = torch.where(sphere_sel[:, None], sphere_n, gather_rows(planes.normal, ip))
    mat = torch.where(sphere_sel, sphere_m, planes.material[ip])
    kind = torch.where(sphere_sel & (ts < _BIG), 1, torch.where(tp < _BIG, 2, 0))
    idx = torch.where(sphere_sel, sphere_i, ip.to(torch.int32))
    if use_boxes:
        if box_normals_up:
            box_n = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(n, 3)
        else:
            box_n = _box_normal(origins, dirs, tb, boxes.center, boxes.extents, ib)
        normal = torch.where(box_sel[:, None], box_n, normal)
        mat = torch.where(box_sel, boxes.material[ib], mat)
        idx = torch.where(box_sel, ib.to(torch.int32), idx)
    kind = torch.where(box_sel, 3, kind)
    kind = torch.where(hit, kind, 0)
    return HitRecord(t=t, normal=normal, material=mat.to(torch.int32), hit=hit,
                     kind=kind.to(torch.int32), idx=idx, root_lo=root_lo & sphere_sel)
