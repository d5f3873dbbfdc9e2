"""Wavefront path-tracing integrator on torch tensors (port of
``rt_tpu.integrator``): the JAX package's jnp path, which runs no kernel.

A flat ray batch advances through a loop over bounce depth with live-ray
masks, accumulating throughput; the pixel x sample space is batch
dimensions, cut into chunks of rays.  Each bounce intersects every ray with
every primitive (:func:`rt_tpu_torch.ops.intersect.closest_hit`) and
scatters it (:func:`rt_tpu_torch.materials.scatter`) with draws from the
threefry stream (:mod:`rt_tpu_torch.rng`), keyed as the JAX package keys
them, so that a frame here is the JAX package's frame up to float rounding:

* sample s, chunk c: ``kc = fold(key, s, chunk_offset + c)``; the jitter
  is ``uniform(fold(kc, 0), (chunk, 2))`` (sample 0 sits at the pixel
  centre), the trace's key ``fold(kc, 3)``;
* bounce b of a trace with key k: ``kb = fold(k, b)``, the scatter's unit
  vectors ``unit_vector(fold(kb, 1))`` and its coins
  ``uniform(fold(kb, 2))``.

The chunk size is :func:`default_ray_chunk` clamped to the power of two
above the pixel count, as in the JAX package: the chunk index is folded
into the key, so another chunk size renders another frame.

Semantics (mg_ray_tracer.cpp): sky on a miss, lerp(white, (0.5, 0.7, 1.0),
0.5 * (dir.y + 1)) (:164); a ray that exhausts ``max_bounces`` or is
absorbed contributes black (:157-158, 173); sample 0 at the pixel centre,
samples >= 1 jittered by U[0,1)^2 (:189); the mean over samples, then a
per-channel sqrt (gamma 2.0) (:195-198).

Gradients: ``grad_mode="autodiff"`` differentiates the whole trace with
``torch.autograd`` (the draws and the discrete decisions carry no
gradient, the detached-sampling convention of :mod:`rt_tpu_torch.diff`);
``"replay"`` records each chunk's path structure without a graph and
differentiates the replay of it (:mod:`rt_tpu_torch.replay`).  ``remat``
checkpoints each chunk (``torch.utils.checkpoint``), so the backward
recomputes a chunk's bounces instead of keeping them; the draws come from
counters, not from torch's generator, so the recomputation is exact.

The rasterizer preview (renderers/rasterizer.cpp) and the null renderer
are here too.  Every entry point takes ``device`` and defaults to the
card; on the card no matrix product may run in TF32.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import rng as _rng
from .camera import _norm3, generate_rays, screen_to_world
from .colour import colour_from_hex
from .materials import personality_classes, scatter
from .ops.intersect import closest_hit, gather_rows, sqrt_rn

__all__ = [
    "trace_batch",
    "render_image",
    "render_pixels",
    "render_rasterizer",
    "render_null",
    "sky_colour",
    "default_ray_chunk",
]

_SKY_BLUE = (0.5, 0.7, 1.0)


def sky_colour(dirs: torch.Tensor) -> torch.Tensor:
    """Background gradient (mg_ray_tracer.cpp:164) for (..., 3) unit
    directions: white at the horizon, sky blue overhead."""
    t = 0.5 * (dirs[..., 1] + 1.0)
    # (1 - t) * white + t * blue per channel, white being 1: the constants
    # stay scalars (a tensor made on the card per bounce would be a copy
    # that waits for the card)
    return torch.stack([(1.0 - t) + t * b for b in _SKY_BLUE], dim=-1)


def _device(device) -> torch.device:
    """``device`` as a torch device, checked: CUDA must be present when
    asked for, and matrix products on the card must not run in TF32 (the
    camera's rotation is a matrix product)."""
    from .ops.tables import _device as checked

    dev = checked(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is on: the integrator "
                           "needs full float32 matrix products")
    return dev


def _pixel_grid(size: tuple[int, int], device="cpu") -> torch.Tensor:
    """(W*H, 2) float32 integer pixel coordinates (x, y), pixel i at
    (i % W, i // W) (image.hpp:82-85)."""
    w, h = size
    idx = torch.arange(w * h, device=device)
    return torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)


def _scene_hit_fn(scene, include_boxes):
    def hit_fn(o, d):
        return closest_hit(scene.spheres, scene.planes, scene.boxes, o, d,
                           include_boxes=include_boxes)
    return hit_fn


def _draws(key, depth: int, n: int, rng_mode: str, device):
    """The scatter draws of bounces 0 to depth-1 for n rays, bounce b's from
    ``fold(key, b)``: (unit vectors (depth, n, 3), coins (depth, n)).  All
    bounces go through one pass of threefry ops each (a list of keys): on
    the card the path is bound by the host's torch calls, and a pass per
    bounce would be 45% of them."""
    kbs = [_rng.fold(key, b) for b in range(depth)]
    return (_rng.unit_vector([_rng.fold(kb, 1) for kb in kbs], (n,), mode=rng_mode,
                             device=device),
            _rng.uniform([_rng.fold(kb, 2) for kb in kbs], (n,), device=device))


def trace_batch(
    scene,
    origins: torch.Tensor,
    dirs: torch.Tensor,
    key,
    *,
    personality: str = "mg",
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    include_boxes: bool = False,
    hit_fn=None,
    records: Optional[list] = None,
) -> torch.Tensor:
    """Trace a flat batch of rays to radiance: (N, 3) float32.

    ``trace()`` (mg_ray_tracer.cpp:155-174) for every ray of the batch, as a
    loop over ``max_bounces`` with live masks; every bounce scatters every
    ray, as the JAX package's scan does.  ``hit_fn(o, d) -> HitRecord``
    replaces the closest hit.  ``records``, a list, receives each bounce's
    :class:`rt_tpu_torch.replay.PathRecords` of (N,) tensors
    (:func:`rt_tpu_torch.replay.trace_batch_recorded`).
    """
    if max_bounces is None:
        max_bounces = scene.max_bounces
    dev = origins.device
    classes = personality_classes(personality).to(dev)
    if hit_fn is None:
        hit_fn = _scene_hit_fn(scene, include_boxes)
    n = origins.shape[0]
    o, d = origins, dirs
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    ur, coin = _draws(key, max_bounces, n, rng_mode, dev)
    for b in range(max_bounces):
        rec = hit_fn(o, d)
        miss_now = live & ~rec.hit
        rad = rad + torch.where(miss_now[:, None], thr * sky_colour(d), 0.0)

        live_h = live & rec.hit
        brdf_class = classes[scene.materials.type[rec.material.long()].long()]
        sc = scatter(scene.materials, brdf_class, rec.material, d, rec.normal, ur[b], coin[b])

        new_o = o + torch.where(rec.hit, rec.t, 0.0)[:, None] * d
        alive = live_h & ~sc.absorbed
        if records is not None:
            from .replay import PathRecords

            records.append(PathRecords(kind=rec.kind, idx=rec.idx, root_lo=rec.root_lo,
                                       live_in=live, miss=miss_now, alive_out=alive,
                                       reflect_bit=sc.reflect_bit, lam_deg=sc.lam_deg))
        thr = torch.where(alive[:, None], thr * sc.attenuation, thr)
        o = torch.where(live_h[:, None], new_o, o)
        d = torch.where(live_h[:, None], sc.direction, d)
        live = alive
    return rad


def default_ray_chunk(scene) -> int:
    """Chunk size keeping the (rays x spheres) intermediates near 256 MB:
    a power of two from 1024 to 65536."""
    s = max(int(scene.spheres.center.shape[0]), 1)
    return max(min(1 << (64 * 1024 * 1024 // (s * 4)).bit_length(), 65536), 1024)


def render_pixels(
    scene,
    size: tuple[int, int],
    pixels: torch.Tensor,
    key,
    *,
    spp: int,
    personality: str = "mg",
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    ray_chunk: Optional[int] = None,
    hit_fn=None,
    chunk_offset: int = 0,
    remat: bool = True,
    grad_mode: str = "autodiff",
    include_boxes: bool = False,
    replay_prims_axis=None,
) -> torch.Tensor:
    """Mean radiance over ``spp`` samples for a flat (N, 2) pixel tensor:
    (N_padded, 3) pre-gamma radiance, N padded up to a chunk multiple, on
    the pixels' device (where every table of ``scene`` lies).

    ``chunk_offset`` biases the per-chunk key fold (global chunk id =
    ``chunk_offset`` + local index).  ``remat`` checkpoints each chunk's
    trace while autograd records.  ``grad_mode``: "autodiff" differentiates
    the trace, "replay" (:mod:`rt_tpu_torch.replay`) pins the path
    structure and differentiates a replay of it: the same value, the same
    detached-sampling gradient, a cheaper backward.  With a custom
    (primitive-sharded) ``hit_fn``, the replay needs ``replay_prims_axis``,
    the mesh axis of the sphere table (:class:`rt_tpu_torch.dist.MeshAxis`):
    the global-winner replay (:func:`rt_tpu_torch.replay.replay_radiance`)."""
    if max_bounces is None:
        max_bounces = scene.max_bounces
    if grad_mode == "replay":
        if hit_fn is not None and replay_prims_axis is None:
            raise ValueError("grad_mode='replay' with a custom hit_fn needs replay_prims_axis "
                             "(the global-winner replay; rt_tpu_torch.dist)")
        import functools

        from .replay import trace_batch_replay

        trace = functools.partial(trace_batch_replay, prims_axis=replay_prims_axis)
    elif grad_mode == "autodiff":
        trace = trace_batch
    else:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    dev = pixels.device
    n = pixels.shape[0]
    if ray_chunk is None:
        ray_chunk = default_ray_chunk(scene)
    ray_chunk = min(ray_chunk, 1 << (max(n - 1, 1)).bit_length())
    n_chunks = -(-n // ray_chunk)
    chunks = torch.cat([pixels, pixels.new_zeros((n_chunks * ray_chunk - n, 2))])
    chunks = chunks.reshape(n_chunks, ray_chunk, 2)

    def chunk_body(s: int, c: int, chunk_pix: torch.Tensor) -> torch.Tensor:
        kc = _rng.fold(key, s, chunk_offset + c)
        off = 0.5 if s == 0 else _rng.uniform(_rng.fold(kc, 0), (ray_chunk, 2), device=dev)
        o, d = generate_rays(scene.camera, size, chunk_pix + off)
        return trace(scene, o, d, _rng.fold(kc, 3), personality=personality,
                     max_bounces=max_bounces, rng_mode=rng_mode, hit_fn=hit_fn,
                     include_boxes=include_boxes)

    def run(s, c):
        if remat and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            return checkpoint(chunk_body, s, c, chunks[c], use_reentrant=False)
        return chunk_body(s, c, chunks[c])

    acc = torch.zeros((n_chunks * ray_chunk, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        acc = acc + torch.cat([run(s, c) for c in range(n_chunks)])
    return acc / spp


def render_image(
    scene,
    size: tuple[int, int],
    key,
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    ray_chunk: Optional[int] = None,
    gamma: bool = True,
    hit_fn=None,
    chunk_offset: int = 0,
    remat: bool = True,
    grad_mode: str = "autodiff",
    include_boxes: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Full path-traced frame: (H, W, 3) float32 on ``device``
    (pre-quantization).

    The per-pixel worker of mg_ray_tracer.cpp:182-204: ``spp`` samples
    (default the scene's), sample 0 at the pixel centre, the mean, and the
    sqrt gamma unless ``gamma=False``.  ``key`` is a :mod:`rt_tpu_torch.rng`
    key.  ``scene`` is moved to ``device``; autograd through the frame
    reaches the tensors of a scene already there."""
    dev = _device(device)
    w, h = size
    scene = scene.to(dev)
    acc = render_pixels(
        scene, size, _pixel_grid(size, dev), key,
        spp=scene.samples_per_pixel if spp is None else spp, personality=personality,
        max_bounces=max_bounces, rng_mode=rng_mode, ray_chunk=ray_chunk, hit_fn=hit_fn,
        chunk_offset=chunk_offset, remat=remat, grad_mode=grad_mode, include_boxes=include_boxes,
    )
    img = acc[:w * h]
    if gamma:
        img = sqrt_rn(torch.clamp_min(img, 0.0))
    return img.reshape(h, w, 3)


def render_rasterizer(scene, size: tuple[int, int], key=None, *, compat_colours: bool = True,
                      device="cuda", **_unused) -> torch.Tensor:
    """One-bounce preview renderer (renderers/rasterizer.cpp:22-88):
    (H, W, 3) float32 on ``device``.

    The primary ray at the pixel centre; the closest hit with boxes, whose
    normal stays 'up' (rasterizer.cpp:38,55-58), in the preview's tie
    order; shade = min(0.25 + 0.75 * dot(to_eye, n) * albedo, 1), with no
    lower clamp (back faces go negative, as in the reference); a hit at or
    past |far - near| + 1 along the ray is a miss (rasterizer.cpp:33-35);
    a miss takes the vertical sky gradient lerp(0xD0E4FF, 0xEEF5FF,
    y/(H-1)) (rasterizer.cpp:65-66, 79-82)."""
    dev = _device(device)
    w, h = size
    scene = scene.to(dev)
    grid = _pixel_grid(size, dev)
    o, d = generate_rays(scene.camera, size, grid + 0.5)
    rec = closest_hit(scene.spheres, scene.planes, scene.boxes, o, d, include_boxes=True,
                      box_normals_up=True, tie_order="rasterizer")
    near_pos = screen_to_world(scene.camera, size, grid + 0.5, 0.0)
    far_pos = screen_to_world(scene.camera, size, grid + 0.5, 1.0)
    hit = rec.hit & (rec.t < _norm3(far_pos - near_pos) + 1.0)

    albedo = gather_rows(scene.materials.albedo, rec.material)[:, :3]
    lam = ((-d) * rec.normal).sum(dim=-1, keepdim=True) * albedo
    shade = torch.clamp_max(0.25 + lam * 0.75, 1.0)

    def sky_end(hex_rgb):
        return torch.tensor(colour_from_hex(hex_rgb, compat=compat_colours)[:3],
                            dtype=torch.float32, device=dev)

    ty = (grid[:, 1] / float(max(h - 1, 1)))[:, None]
    sky = (1.0 - ty) * sky_end(0xD0E4FF) + ty * sky_end(0xEEF5FF)
    return torch.where(hit[:, None], shade, sky).reshape(h, w, 3)


def render_null(scene, size: tuple[int, int], key=None, *, device="cuda",
                **_unused) -> torch.Tensor:
    """No-op renderer (renderers/null_renderer.cpp:7-15): the app clears
    the buffer to black first (main.cpp:318), so the frame is black."""
    w, h = size
    return torch.zeros((h, w, 3), dtype=torch.float32, device=_device(device))
