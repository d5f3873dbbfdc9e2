"""Ray-primitive helpers on torch tensors (port of ``rt_tpu.ops.intersect``,
the part that the replay needs).

* ``MIN_HIT_DIST`` — the reference's ``min_hit_dist`` epsilon
  (mg_ray_tracer.cpp:20).
* :func:`safe_normalize` — normalization with NaN-free gradients.
* :func:`dot3` and :func:`gather_rows` — the dot product and the table
  fetch of the replay and ``materials.scatter``.

The replay retraces the paths that a record kernel traced, and a ray that
grazes a sphere has a gradient of order 1/sqrt(discriminant): a rounding
difference there moves the whole gradient (at 800x600 by 0.5% of its
largest entry).  So these helpers round as the kernels do (``csrc/trace.cuh``
with --fmad=false): a dot product is x0*y0 + x1*y1 + x2*y2 in that order,
a normalization multiplies by 1/sqrt (the kernels' ``rsqrt_rn``; torch's
rsqrt on the card is not correctly rounded), and on the card the replay's
rays are then the kernel's to the bit.  :func:`gather_rows` sums its
gradient in float64: float32 adds of a million rays into one table row
lose the gradient's low digits.

``closest_hit`` (and ``hit_spheres``/``hit_planes``/``hit_boxes``) waits
for the pure-torch integrator, which also needs the threefry ``rng``
(ROADMAP queue 1 items 1 and 2); the kernels carry their own closest-hit
scan (``csrc/trace.cuh``).
"""

from __future__ import annotations

import torch

__all__ = ["MIN_HIT_DIST", "dot3", "gather_rows", "safe_normalize"]

MIN_HIT_DIST = 0.001


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
