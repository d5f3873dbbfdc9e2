"""Differentiable rendering: scene parameters, losses, gradients (port of
``rt_tpu.diff``).

The differentiable leaves of a scene — sphere centres and radii, material
albedo, roughness and reflectivity (which doubles as the dielectric IOR),
camera position and rotation, and with boxes the box centres and extents —
are a plain dict of tensors keyed ``"<table>.<field>"``, as in the JAX
package.  :func:`params_from_numpy` carries the JAX package's params
across (``np.asarray`` of each leaf) bit for bit, so the port and the
reference can be differentiated at the same point.

:func:`records_loss_and_grad` is the counterpart of
``pallas_loss_and_grad``: a record kernel traces each sample once and
writes its path structure and draws, and ``torch.autograd`` through
:func:`rt_tpu_torch.replay.replay_radiance` gives the detached-sampling
gradient of the MSE.  It is the gradient route for box scenes (the fused
steps give boxes none) and for camera-pose fitting.

Discrete decisions (the winning hit, the dielectric coin, live masks,
metal absorption) carry no gradient: the detached-sampling convention, no
edge or silhouette gradients.  :func:`loss_and_grad` differentiates the
jnp-style integrator (:func:`rt_tpu_torch.integrator.render_image`), by
default through the replay (``grad_mode="replay"``).  Losses are taken on
pre-gamma radiance: the sqrt gamma has an infinite derivative at zero.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["extract_params", "apply_params", "params_from_numpy", "render_for_loss", "image_loss",
           "loss_and_grad", "records_loss_and_grad"]

# Differentiable leaves, as (table, field) pairs.
_PARAM_FIELDS = (
    ("spheres", "center"),
    ("spheres", "radius"),
    ("materials", "albedo"),
    ("materials", "roughness"),
    ("materials", "reflectivity"),
    ("camera", "position"),
    ("camera", "rotation"),
)


def extract_params(scene) -> dict[str, torch.Tensor]:
    """The differentiable parameters of ``scene``.  Scenes with boxes (the
    ``--boxes`` extension) also expose boxes.center and boxes.extents."""
    fields = _PARAM_FIELDS
    if scene.boxes.count > 0:
        fields = fields + (("boxes", "center"), ("boxes", "extents"))
    return {f"{a}.{b}": getattr(getattr(scene, a), b) for a, b in fields}


def apply_params(scene, params: dict[str, torch.Tensor]):
    """``scene`` with the given parameter values substituted."""
    groups: dict[str, dict[str, Any]] = {}
    for k, v in params.items():
        a, b = k.split(".")
        groups.setdefault(a, {})[b] = v
    for a, kv in groups.items():
        sub = dataclasses.replace(getattr(scene, a), **kv)
        scene = dataclasses.replace(scene, **{a: sub})
    return scene


def params_from_numpy(d: dict, device="cuda") -> dict[str, torch.Tensor]:
    """Params given as arrays (for instance ``{k: np.asarray(v)}`` of the
    JAX package's params) as this package's dict of tensors on ``device``
    (the card unless the caller asks for the CPU, as every entry point),
    with the same dtypes and values."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}


def render_for_loss(params, scene, size: tuple[int, int], key, *, spp: int = 4,
                    max_bounces: int = 4, personality: str = "mg", render_fn=None,
                    grad_mode: str = "replay", device="cuda", **opts) -> torch.Tensor:
    """The frame at ``params`` as pre-gamma radiance, (H, W, 3) on
    ``device``.  ``render_fn(scene, size, key, **opts)`` replaces
    :func:`rt_tpu_torch.integrator.render_image`; ``grad_mode`` defaults to
    the replay (:mod:`rt_tpu_torch.replay`): the same value and gradient,
    a far cheaper backward."""
    from .integrator import _device, render_image

    dev = _device(device)
    scene = apply_params(scene.to(dev), {k: torch.as_tensor(v).to(dev) for k, v in params.items()})
    if render_fn is None:
        render_fn = render_image
    return render_fn(scene, size, key, spp=spp, max_bounces=max_bounces,
                     personality=personality, gamma=False, grad_mode=grad_mode, device=dev,
                     **opts)


def _as_tensor(a, device) -> torch.Tensor:
    """A tensor or an array (copied) as a float32 tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


def image_loss(params, scene, target, size, key, *, device="cuda", **opts) -> torch.Tensor:
    """Mean squared error of the frame at ``params`` against a (H, W, 3)
    pre-gamma ``target``."""
    img = render_for_loss(params, scene, size, key, device=device, **opts)
    return torch.mean((img - _as_tensor(target, img.device)) ** 2)


def loss_and_grad(params, scene, target, size, key, *, device="cuda", **opts):
    """``(loss, grads)``: the loss of :func:`image_loss` and its gradient
    with respect to every tensor of ``params`` (a dict keyed like
    :func:`extract_params`), on ``device``.  Deterministic for a fixed
    ``key``, so finite differences check it directly."""
    from .integrator import _device

    dev = _device(device)
    leaves = {k: torch.as_tensor(v).to(dev).detach().requires_grad_(True)
              for k, v in params.items()}
    loss = image_loss(leaves, scene, target, size, key, device=dev, **opts)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def _record_rays(camera, size, grid, jitter):
    """The record kernels' camera rays through pixels ``grid`` (N, 2) at
    offsets ``jitter`` (N, 2): ``render._raygen_plain`` (trace.cuh
    camera_ray) on the camera's position and rotation tensors, so
    differentiable in them: ``(origins, directions)``, each (N, 3)."""
    from .ops.render import _inv_size, _raygen_plain
    from .ops.tables import _camera_tail

    c = [*camera.position, *camera.rotation.reshape(-1), *_camera_tail(camera, size)[:3]]
    o3, d3 = _raygen_plain(c, grid[:, 0], grid[:, 1], jitter[:, 0], jitter[:, 1],
                           *_inv_size(*size))
    return torch.stack(o3, dim=-1), torch.stack(d3, dim=-1)


def _replay_value_and_grad(params, scene, target, recs, *, spp, size, personality, max_bounces,
                           include_boxes, grid):
    """``(loss, grads)``: the MSE of the mean of the per-sample replays over
    the recorded paths against ``target``, and its gradient by autograd
    (``rt_tpu.diff._replay_value_and_grad``).  ``recs`` is the flat record
    set (:func:`rt_tpu_torch.ops.render.records_to_flat`) of the ``spp``
    samples in the record kernels' sample-concatenated layout (column ``s *
    N + i``: pixel i of sample s).  The samples replay as one batch of
    rays, from the record kernels' own camera rays (:func:`_record_rays`,
    where JAX takes ``generate_rays``: the same rays up to rounding, and
    the replay of a ray that grazes a sphere follows the recorded path only
    if it rounds as the kernel did), and are summed in sample order."""
    from .replay import PathRecords, replay_radiance

    w, h = size
    n = w * h
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    sc = apply_params(scene, leaves)
    o, d = _record_rays(sc.camera, (w, h), grid.repeat(spp, 1), recs["jitter"])
    records = PathRecords(*(recs[k] for k in PathRecords._fields))
    rad = replay_radiance(sc, o, d, None, records, personality=personality,
                          max_bounces=max_bounces, draws=(recs["ur"], recs["coin"]),
                          include_boxes=include_boxes).reshape(spp, n, 3)
    acc = rad[0]
    for s in range(1, spp):
        acc = acc + rad[s]
    img = (acc / spp).reshape(h, w, 3)
    loss = torch.mean((img - target) ** 2)
    keys = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys], allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in zip(keys, grads)}


def records_loss_and_grad(params, scene, target, size, seed: int = 0, *, spp: int = 4,
                          max_bounces: int = 8, personality: str = "mg",
                          rng_mode: str = "reference", include_boxes: bool = False,
                          device="cuda"):
    """``(loss, grads)`` with a record kernel as the forward pass and the
    replay as the differentiable pass (the counterpart of
    ``pallas_loss_and_grad``).

    Sample s traces at seed ``seed * 100003 + s`` (wrapping int32),
    sample 0 at the pixel centre: the same draws as
    :func:`rt_tpu_torch.ops.grad.make_mse_step` at ``seed``.  The record
    pass runs at the concrete ``params``: while the scene fits the render
    kernel (640 primitives), one launch of its record form traces every
    sample into the layout the replay reads; else the blockwise record
    kernel (16384) traces one sample a launch, whose records are
    concatenated into the same layout.  Its tables are runtime inputs, so
    changed parameters cost no rebuild.  ``include_boxes`` traces the
    --boxes extension: kind-3 records and the smooth slab replay, so
    ``boxes.center`` and ``boxes.extents`` get gradients.  ``target`` is
    (H, W, 3) pre-gamma radiance; the loss is the MSE of the spp-mean image
    against it and ``grads`` holds the gradient of every key of ``params``,
    on ``device``."""
    from .integrator import _pixel_grid
    from .ops import blockwise as BW
    from .ops import render as R
    from .ops import tables as T
    from .ops.grad import _sample_seeds

    dev = T._device(device)
    w, h = size
    scene = scene.to(dev)
    params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    concrete = apply_params(scene, {k: v.detach() for k, v in params.items()})
    use_boxes = include_boxes and scene.boxes.count > 0
    seeds = T._upload(_sample_seeds(seed, spp), dev)
    # the record pass takes the pose as values: the camera reaches the
    # loss only through the replay's camera rays
    cam = T._upload(T._pack_camera(concrete.camera, size), dev)
    kw = dict(size=size, max_bounces=max_bounces, rng_mode=rng_mode)
    if R.supported(concrete, include_boxes):
        tables = T._unrolled_tables(concrete, personality, use_boxes, dev)
        raw = R.render_record_tile(*tables, cam, seeds, center_sample=True, **kw)[1]
    elif BW.blockwise_supported(concrete, include_boxes):
        tables = T._padded_tables(concrete, personality, use_boxes, dev)
        sets = [BW.render_record_blockwise_tile(*tables, cam, seeds[s:s + 1],
                                                center_sample=(s == 0), **kw)[1]
                for s in range(spp)]
        raw = {k: torch.cat([r[k] for r in sets], dim=1) for k in sets[0]}
    else:
        raise ValueError("scene exceeds every record-kernel limit")
    tgt = torch.as_tensor(target, dtype=torch.float32).reshape(h, w, 3).to(dev)
    return _replay_value_and_grad(params, scene, tgt, R.records_to_flat(raw), spp=spp,
                                  size=size, personality=personality, max_bounces=max_bounces,
                                  include_boxes=use_boxes, grid=_pixel_grid(size, dev))
