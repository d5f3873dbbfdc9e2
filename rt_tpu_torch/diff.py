"""Differentiable scene parameters (port of ``rt_tpu.diff``'s parameter
plumbing).

The differentiable leaves of a scene — sphere centres and radii, material
albedo, roughness and reflectivity (which doubles as the dielectric IOR),
camera position and rotation — are a plain dict of tensors keyed
``"<table>.<field>"``, as in the JAX package.  :func:`params_from_numpy`
carries the JAX package's params across (``np.asarray`` of each leaf) bit
for bit, so the port and the reference can be differentiated at the same
point.

Still to port: ``render_for_loss``, ``image_loss`` and ``loss_and_grad``
need the pure-torch integrator, and ``pallas_loss_and_grad`` needs the
record kernel and ``replay`` (ROADMAP queue 1 items 2 and 5).  The fused
training step, :func:`rt_tpu_torch.ops.grad.make_mse_step`, needs neither.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["extract_params", "apply_params", "params_from_numpy"]

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


def params_from_numpy(d: dict, device="cpu") -> dict[str, torch.Tensor]:
    """Params given as arrays (for instance ``{k: np.asarray(v)}`` of the
    JAX package's params) as this package's dict of tensors on ``device``,
    with the same dtypes and values."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}
