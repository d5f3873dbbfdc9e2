"""Integrator helpers on torch tensors (port of ``rt_tpu.integrator``, the
part that the replay needs).

* :func:`sky_colour` — the background gradient (mg_ray_tracer.cpp:164).
* :func:`_pixel_grid` — integer pixel coordinates in the reference's
  row-major order (image.hpp:82-85).

The rest of the module (``trace_batch``, ``render_image``,
``render_pixels``, the rasterizer and null renderers) waits for the
threefry ``rng`` and ``ops.intersect.closest_hit`` (ROADMAP queue 1 items
1 and 2).  The kernels of :mod:`rt_tpu_torch.ops` render without it.
"""

from __future__ import annotations

import torch

__all__ = ["sky_colour"]

_WHITE = (1.0, 1.0, 1.0)
_SKY_BLUE = (0.5, 0.7, 1.0)


def sky_colour(dirs: torch.Tensor) -> torch.Tensor:
    """Background gradient (mg_ray_tracer.cpp:164) for (..., 3) unit
    directions: white at the horizon, sky blue overhead."""
    t = 0.5 * (dirs[..., 1] + 1.0)
    white = torch.tensor(_WHITE, dtype=torch.float32, device=dirs.device)
    blue = torch.tensor(_SKY_BLUE, dtype=torch.float32, device=dirs.device)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def _pixel_grid(size: tuple[int, int], device="cpu") -> torch.Tensor:
    """(W*H, 2) float32 integer pixel coordinates (x, y), pixel i at
    (i % W, i // W)."""
    w, h = size
    idx = torch.arange(w * h, device=device)
    return torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
