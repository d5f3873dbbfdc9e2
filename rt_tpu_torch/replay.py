"""Replay-mode gradients: the radiance recomputed as a smooth function of
the scene parameters along a recorded path (port of ``rt_tpu.replay``).

Under the detached-sampling convention (:mod:`rt_tpu_torch.diff`) every
discrete decision of a path is constant in the backward pass: the winning
primitive, the sphere root, the live, miss and absorbed masks, the
dielectric coin and the lambert degeneracy.  A record kernel
(:func:`rt_tpu_torch.ops.render.render_record`,
:func:`rt_tpu_torch.ops.blockwise.render_record_blockwise`) traces the
path once and writes those decisions and its random draws per bounce;
:func:`replay_radiance` then recomputes the radiance with the decisions
pinned: per bounce it solves the hit for the one recorded primitive (O(1)
per ray instead of a scan), fetches its parameters, and applies the
recorded masks.  ``torch.autograd`` through it is the gradient, as
``jax.grad`` through the JAX replay is.  Its arithmetic rounds as the
kernels' does (:mod:`rt_tpu_torch.ops.intersect`), so that fed the record
kernel's own camera rays it retraces each path to the bit on the card.

The JAX replay fetches the recorded primitive's parameters with one-hot
contractions at precision "highest"; here index gathers fetch the same
values (a one-hot (N, S) matrix per bounce would hold 0.7 G floats at
960x540 x 2 spp with 684 primitives), and autograd adds the gradients back
into the gathered rows.  Every guard of the JAX replay is kept, so no
masked-out lane feeds a non-finite value into the backward; ``.detach()``
stands where JAX uses ``stop_gradient``.

With ``draws=None`` the replay regenerates the threefry draws from
``key`` with the folds of :func:`rt_tpu_torch.integrator.trace_batch`.
:func:`trace_batch_recorded` is that trace with its records, and
:func:`trace_batch_replay` records without a graph and returns the replay:
the integrator's ``grad_mode="replay"``.  Not ported: ``prims_axis`` (the
primitive-sharded replay; ROADMAP queue 1 item 8), which raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .integrator import _draws, sky_colour, trace_batch
from .materials import personality_classes, scatter
from .ops.intersect import MIN_HIT_DIST, dot3, gather_rows, safe_normalize

__all__ = ["PathRecords", "trace_batch_recorded", "replay_radiance", "trace_batch_replay"]


class PathRecords(NamedTuple):
    """Stacked (max_bounces, N) discrete path structure."""

    kind: torch.Tensor         # int: 0 miss, 1 sphere, 2 plane, 3 box (--boxes)
    idx: torch.Tensor          # int: winner index within its class
    root_lo: torch.Tensor      # bool: the sphere's near root
    live_in: torch.Tensor      # bool: the ray is alive at the bounce's entry
    miss: torch.Tensor         # bool: alive and missed -> the sky contributes
    alive_out: torch.Tensor    # bool: alive after the bounce (hit, not absorbed)
    reflect_bit: torch.Tensor  # bool: the dielectric's reflect branch
    lam_deg: torch.Tensor      # bool: the lambert degenerate fallback


def _fetch(table: torch.Tensor, idx: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` on the lanes of ``sel`` and zero elsewhere, as the
    JAX replay's masked one-hot contraction gives (an empty table gives
    zeros)."""
    shape = idx.shape + table.shape[1:]
    if table.shape[0] == 0:
        return torch.zeros(shape, dtype=table.dtype, device=idx.device)
    rows = gather_rows(table, torch.where(sel, idx, 0))
    mask = sel.reshape(sel.shape + (1,) * (rows.dim() - 1))
    return torch.where(mask, rows, 0.0)


def trace_batch_recorded(scene, origins, dirs, key, *, personality: str = "mg",
                         max_bounces: Optional[int] = None, rng_mode: str = "reference",
                         hit_fn=None, include_boxes: bool = False):
    """The forward trace with its records: ``(radiance (N, 3), PathRecords)``
    with (max_bounces, N) records.  It is
    :func:`rt_tpu_torch.integrator.trace_batch` itself (the same folds, the
    same update order), reading each bounce's decisions as it goes."""
    steps = []
    rad = trace_batch(scene, origins, dirs, key, personality=personality,
                      max_bounces=max_bounces, rng_mode=rng_mode, include_boxes=include_boxes,
                      hit_fn=hit_fn, records=steps)
    return rad, PathRecords(*(torch.stack(field) for field in zip(*steps)))


def replay_radiance(scene, origins, dirs, key, records: PathRecords, *, personality: str = "mg",
                    max_bounces: Optional[int] = None, rng_mode: str = "reference", draws=None,
                    prims_axis: Optional[str] = None, include_boxes: bool = False) -> torch.Tensor:
    """Differentiable (N, 3) radiance with the discrete path structure
    pinned to ``records``.

    ``draws`` = (unit vectors (B, N, 3), coins (B, N)): the draws the
    record kernel used; without them the threefry draws of ``key`` (an
    :mod:`rt_tpu_torch.rng` key) in ``rng_mode``, as
    :func:`rt_tpu_torch.integrator.trace_batch` draws them.
    ``origins``/``dirs`` are the (N, 3) camera rays and every table of
    ``scene`` lies on their device."""
    if prims_axis is not None:
        raise NotImplementedError("the primitive-sharded replay waits for dist "
                                  "(ROADMAP queue 1 item 8)")
    if max_bounces is None:
        max_bounces = scene.max_bounces
    dev = origins.device
    classes = personality_classes(personality).to(dev)
    sph, pln, box = scene.spheres, scene.planes, scene.boxes
    # kind=3 records exist only when the forward traced --boxes; the box
    # branch drops out entirely for box-free traces
    use_boxes = include_boxes and box.count > 0

    o, d = origins, dirs
    n = o.shape[0]
    if draws is None:
        draws = _draws(key, max_bounces, n, rng_mode, dev)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for b in range(max_bounces):
        kind, idx = records.kind[b], records.idx[b]
        is_sphere = kind == 1
        is_plane = kind == 2
        hit = kind > 0

        # differentiable hit for the recorded primitive
        c = _fetch(sph.center, idx, is_sphere)                  # (N, 3)
        radius = _fetch(sph.radius, idx, is_sphere)             # (N,)
        oc = o - c
        bq = dot3(oc, d)
        c0 = dot3(oc, oc) - radius * radius
        disc = bq * bq - c0
        sq = torch.sqrt(torch.where(is_sphere, torch.clamp_min(disc, 1e-12), 1.0))
        sq = torch.where(is_sphere, sq, 0.0)
        t_s = torch.where(records.root_lo[b], -bq - sq, -bq + sq)

        pn = _fetch(pln.normal, idx, is_plane)                  # (N, 3)
        pd = _fetch(pln.d, idx, is_plane)                       # (N,)
        ndotd = dot3(pn, d)
        safe_dd = torch.where(torch.abs(ndotd) > 1e-12, ndotd, 1.0)
        t_p = -(dot3(pn, o) + pd) / safe_dd

        t = torch.where(is_sphere, t_s, torch.where(is_plane, t_p, 0.0))
        if use_boxes:
            # the smooth slab t of the recorded box: the slab max/min pick
            # the face and their gradient flows through that face's plane
            # only; the face choice is the detached decision
            is_box = kind == 3
            bc = _fetch(box.center, idx, is_box)
            be = _fetch(box.extents, idx, is_box)
            inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12)
            ta = (bc - be - o) * inv
            tb2 = (bc + be - o) * inv
            # amax/amin share the gradient among tied entries, as jnp.max does
            tmn = torch.amax(torch.minimum(ta, tb2), dim=-1)
            tmx = torch.amin(torch.maximum(ta, tb2), dim=-1)
            use_min = tmn.detach() >= MIN_HIT_DIST
            t = torch.where(is_box, torch.where(use_min, tmn, tmx), t)
        hit_p = o + t[:, None] * d
        normal = torch.where(is_sphere[:, None], safe_normalize(hit_p - c), pn)
        if use_boxes:
            eb = torch.clamp_min(be.detach(), 1e-12)
            local = (hit_p - bc).detach() / eb
            ax = torch.argmax(torch.abs(local), dim=-1, keepdim=True)
            bn = torch.zeros_like(local).scatter_(-1, ax, torch.sign(torch.gather(local, -1, ax)))
            normal = torch.where(is_box[:, None], bn, normal)

        # material id: integer gathers, indices clamped into their table
        s_mat = sph.material[torch.where(is_sphere, idx, 0).long()]
        p_mat = pln.material[torch.where(is_plane, idx, 0).long()]
        mat = torch.where(is_sphere, s_mat, p_mat)
        if use_boxes:
            mat = torch.where(is_box, box.material[torch.where(is_box, idx, 0).long()], mat)

        # the sky, on the recorded miss mask
        rad = rad + torch.where(records.miss[b][:, None], thr * sky_colour(d), 0.0)

        # the scatter with its decisions pinned
        brdf_class = classes[scene.materials.type[mat.long()].long()]
        sc = scatter(scene.materials, brdf_class, mat, d, normal, draws[0][b], draws[1][b],
                     decisions=(records.reflect_bit[b], records.lam_deg[b]))

        live_h = records.live_in[b] & hit
        thr = torch.where(records.alive_out[b][:, None], thr * sc.attenuation, thr)
        o = torch.where(live_h[:, None], hit_p, o)
        d = torch.where(live_h[:, None], sc.direction, d)
    return rad


def trace_batch_replay(scene, origins, dirs, key, *, personality: str = "mg",
                       max_bounces: Optional[int] = None, rng_mode: str = "reference",
                       hit_fn=None, prims_axis: Optional[str] = None,
                       include_boxes: bool = False, **_unused) -> torch.Tensor:
    """:func:`rt_tpu_torch.integrator.trace_batch` with replay-mode
    gradients: the paths are recorded without a graph, and the replay of
    them is returned (the same value up to rounding, the detached-sampling
    gradient at a fraction of the backward's cost)."""
    with torch.no_grad():
        _, records = trace_batch_recorded(scene, origins, dirs, key, personality=personality,
                                          max_bounces=max_bounces, rng_mode=rng_mode,
                                          hit_fn=hit_fn, include_boxes=include_boxes)
    return replay_radiance(scene, origins, dirs, key, records, personality=personality,
                           max_bounces=max_bounces, rng_mode=rng_mode, prims_axis=prims_axis,
                           include_boxes=include_boxes)
