"""Camera math on torch tensors (port of ``rt_tpu.camera``).

Re-implements the reference's pinhole camera (camera.hpp):

* :func:`generate_rays` computes the primary ray of ``viewport()`` /
  ``screen_to_world`` (camera.hpp:42-48, mg_ray_tracer.cpp:189-193)
  directly: the pixel's view-space direction scaled to the near plane,
  rotated into world space.  Ray origin lies on the near plane.
* NDC convention (camera.hpp:42-48): x = 2*sx/W - 1, y = 1 - 2*sy/H.
* vfov is the vertical field of view, default pi/4 (camera.hpp:54).
* :func:`view_projection`, :func:`world_to_screen` and
  :func:`screen_to_world` are ``viewport()``'s matrices and projections
  (camera.hpp:21-48, 121-137), with NDC depth in [0, 1] (near → 0, far →
  1); the rasterizer bounds its hits with them.

Every function takes and returns float32 tensors on the device of its
inputs.  :func:`look_rotation` writes its norms and cross products out
component by component, with the fused multiply-adds that the jnp version
gets from XLA on the CPU, so that scene loading gives the JAX package's
camera bit for bit (``tests/test_torch_host.py``).
"""

from __future__ import annotations

import torch

__all__ = ["look_rotation", "rotate_yaw", "rotate_pitch", "generate_rays", "view_projection",
           "world_to_screen", "screen_to_world"]


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding, as XLA's CPU backend contracts
    it: the float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of length 3, contracted as
    ``jnp.linalg.norm`` is on the CPU: sqrt(fma(z, z, fma(y, y, x*x)))."""
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    # the root is taken in float64 and rounded once: torch's float32 sqrt
    # on the CPU is not correctly rounded
    return torch.sqrt(_fma32(x2, x2, _fma32(x1, x1, x0 * x0)).double()).float()


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross`` as contracted on the CPU: fma(a_i, b_j, -(a_j*b_i))."""
    def c(i, j):
        return _fma32(a[i], b[j], -(a[j] * b[i]))
    return torch.stack([c(1, 2), c(2, 0), c(0, 1)])


def look_rotation(direction: torch.Tensor) -> torch.Tensor:
    """Orthonormal rotation whose -z column (camera forward) is ``direction``.

    Equivalent to ``mat3::from_3d_direction`` as used by ``camera::pose``
    (camera.hpp:116-119): columns are (right, up, backward).  A direction
    parallel to world up (+y) falls back to the z axis as the reference "up".
    """
    direction = torch.as_tensor(direction, dtype=torch.float32)
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=direction.device)
    f = direction / _norm3(direction)
    parallel = bool(torch.abs(torch.dot(f, world_up)) > 0.999999)
    ref_up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=f.device) if parallel else world_up
    right = _cross(f, ref_up)
    right = right / _norm3(right)
    up = _cross(right, f)
    return torch.stack([right, up, -f], dim=1)


def _axis_angle(axis: torch.Tensor, angle: float) -> torch.Tensor:
    """Rotation matrix about a unit axis (Rodrigues)."""
    axis = axis / _norm3(axis)
    x, y, z = axis[0], axis[1], axis[2]
    angle = torch.as_tensor(angle, dtype=torch.float32, device=axis.device)
    c = torch.cos(angle)
    s = torch.sin(angle)
    C = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s]),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s]),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C]),
    ])


def rotate_yaw(rotation: torch.Tensor, angle: float) -> torch.Tensor:
    """Yaw about the *world* up axis (camera.hpp:80-84)."""
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=rotation.device)
    return _axis_angle(up, angle) @ rotation


def rotate_pitch(rotation: torch.Tensor, angle: float) -> torch.Tensor:
    """Pitch about the camera's current right axis (camera.hpp:86-91)."""
    return _axis_angle(rotation[:, 0], angle) @ rotation


def _view_dirs(camera, size, pixel_pos):
    """The view-space direction through each pixel position, rotated into
    world space: (..., 3)."""
    w, h = size
    dev = pixel_pos.device
    th = torch.tan(torch.tensor(camera.vfov, dtype=torch.float32) * 0.5).to(dev)
    aspect = torch.tensor(w / h, dtype=torch.float32, device=dev)
    nx = 2.0 * (pixel_pos[..., 0] / w) - 1.0
    ny = 1.0 - 2.0 * (pixel_pos[..., 1] / h)
    d_view = torch.stack([nx * th * aspect, ny * th, -torch.ones_like(nx)], dim=-1)
    return d_view @ camera.rotation.to(dev).T


def generate_rays(camera, size: tuple[int, int], pixel_pos: torch.Tensor):
    """Primary rays for continuous pixel positions.

    Args:
      camera: a :class:`rt_tpu_torch.scene.Camera`.
      size: (width, height) in pixels.
      pixel_pos: (..., 2) float32 continuous pixel coordinates (the caller
        adds the reference's +0.5 centre offset / jitter,
        mg_ray_tracer.cpp:189).

    Returns:
      (origins, directions): (..., 3) tensors.  Origins lie on the near
      plane; directions are unit (mg_ray_tracer.cpp:190-193).
    """
    dev = pixel_pos.device
    d_world = _view_dirs(camera, size, pixel_pos)
    origins = camera.position.to(dev) + d_world * camera.near
    directions = d_world / _norm3(d_world)[..., None]
    return origins, directions


def view_projection(camera, size: tuple[int, int]) -> torch.Tensor:
    """Full 4x4 view-projection matrix (camera.hpp:121-137): perspective
    with NDC z in [0, 1] composed with the inverse rigid pose."""
    w, h = size
    rot, pos = camera.rotation, camera.position
    f = 1.0 / torch.tan(torch.tensor(camera.vfov, dtype=torch.float32) * 0.5)
    n, fr = camera.near, camera.far
    proj = torch.zeros((4, 4), dtype=torch.float32)
    proj[0, 0], proj[1, 1] = f / (w / h), f
    proj[2, 2], proj[2, 3], proj[3, 2] = fr / (n - fr), n * fr / (n - fr), -1.0
    proj = proj.to(rot.device)
    top = torch.cat([rot.T, -(rot.T @ pos)[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=rot.device)
    return proj @ torch.cat([top, bottom], dim=0)


def world_to_screen(camera, size: tuple[int, int], world_pos: torch.Tensor):
    """Project world positions to pixel coordinates and NDC depth
    (camera.hpp:21-39): ((..., 2) pixels, (...,) depth)."""
    vp = view_projection(camera, size).to(world_pos.device)
    p = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], dim=-1)
    clip = p @ vp.T
    wcoord = clip[..., 3:4]
    ndc = torch.where(wcoord != 0.0, clip / wcoord, clip)
    w, h = size
    sx = (ndc[..., 0] + 1.0) * (w / 2.0)
    sy = (1.0 - ndc[..., 1]) * (h / 2.0)
    return torch.stack([sx, sy], dim=-1), ndc[..., 2]


def screen_to_world(camera, size: tuple[int, int], pixel_pos: torch.Tensor, depth) -> torch.Tensor:
    """Un-project pixels at an NDC depth in [0, 1] (camera.hpp:42-48):
    depth 0 → the near plane, 1 → the far plane."""
    depth = torch.as_tensor(depth, dtype=torch.float32, device=pixel_pos.device)
    # NDC depth d maps to view-space z by the projective interpolation of
    # [near, far]: near*far / ((1-d)*far + d*near)
    z = camera.near * camera.far / ((1.0 - depth) * camera.far + depth * camera.near)
    return camera.position.to(pixel_pos.device) + _view_dirs(camera, size, pixel_pos) * z[..., None]
