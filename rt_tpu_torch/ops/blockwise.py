"""Forward render with runtime primitive tables of up to 16384 rows (port
of ``rt_tpu.ops.pallas_blockwise``'s ``render_forward_blockwise``).

The kernel (``csrc/blockwise_kernel.cu``) traces one pixel per thread as
the render kernel does, reading the tables from device memory (the
sphere scan from compact rows staged in shared memory up to 2048 spheres),
so scenes past the render kernel's 640 primitives render too; its source
comment says what bounds it and where the rows live.  Beside it:

* :func:`render_blockwise_tile_plain` — the same function in plain
  PyTorch.  The JAX blockwise kernel traces exactly the unrolled kernel's
  function (same scan order and tie rules, same draws, same bounce math),
  so this is :func:`rt_tpu_torch.ops.render.render_tile_plain` on the used
  rows of the padded tables.  It is the CPU path and the reference the
  kernel is compared with on the card.
* :func:`render_blockwise_tile` — the kernel wrapper.  A CPU tensor goes to
  the plain version; a CUDA tensor goes to the kernel, and nothing else.
  ``render_blockwise_tile.launches`` counts kernel launches.  With
  ``words=True`` (one sample: the blockwise training step's forward
  launches) it also returns each bounce's winner words, which the
  blockwise gradient kernel replays instead of scanning again.
* :func:`render_forward_blockwise` — the entry point: tables padded to
  their bucket (``tables._padded_tables``), samples chunked in
  calls of 4 with the LCG chunk-seed chain (the JAX ``_meta_rows`` chain,
  which is :func:`rt_tpu_torch.ops.render._chunk_seeds`), the mean and
  gamma.  :func:`render_forward_blockwise_sharded` is its sharded twin
  over a mesh axis of ranks: each rank's launches take its first pixel and
  count (``pix0``, ``count``), so pixel ids and draws stay the frame's.

Not ported: the TPU scan variants and knobs of the JAX entry point
(``mxu``, ``scan``, ``block``, ``cull`` with ``_block_bounds`` and
``_seed_table``, ``order="morton"``, ``rng_impl="hw"``, ``interpret``):
the cull and the Morton order preserve the argmin exactly by design, so
the kernel computes the same function with a plain index-order scan.
Passing one of them is a ``TypeError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import render as _render
from .render import RECORD_KEYS, _inv_size, _record_outputs, _record_plain, render_tile_plain
from .tables import (MAX_BLOCKWISE_PRIMS, _check, _check_tables, _device, _pack_camera,
                     _padded_tables, _upload)

__all__ = ["MAX_BLOCKWISE_PRIMS", "blockwise_supported", "render_blockwise_tile",
           "render_blockwise_tile_plain", "render_forward_blockwise",
           "render_forward_blockwise_sharded",
           "render_record_blockwise_tile", "render_record_blockwise_tile_plain",
           "render_record_blockwise"]


def blockwise_supported(scene, include_boxes: bool = False) -> bool:
    """Whether the blockwise kernel takes this scene (the JAX cap).  Without
    ``include_boxes`` boxes are never tested (the reference's box stub)."""
    total = scene.spheres.count + scene.planes.count
    if include_boxes:
        total += scene.boxes.count
    return total <= MAX_BLOCKWISE_PRIMS


def render_blockwise_tile_plain(spheres, planes, boxes, counts, cam, seeds, *, size, spp,
                                max_bounces, center_sample, rng_mode="reference", words=False,
                                pix0=0, count=None):
    """Plain PyTorch version of the kernel, on the device of ``cam``.

    Args:
      spheres, planes, boxes: padded (rows, 16) float32 tables
        (``tables._padded_tables``); boxes may have 0 rows.
      counts: (n_spheres, n_planes, n_boxes), the used rows of each table;
        n_boxes = 0 leaves boxes untested.
      cam: (16,) float32 camera vector; seeds: (1,) int32.
      size: (width, height); spp: samples in this call; ``center_sample``
        puts sample 0 at the pixel centre.

    Returns the SUM of pre-gamma radiance over the ``spp`` samples,
    (height, width, 3) float32.  ``words=True`` (``spp`` = 1: the training
    step's forward launches) returns ``(sum, words)``, with the sample's
    winner word of every bounce and pixel, (max_bounces, height * width)
    int32: the row, bit 24 for a plane, bit 26 for a box, or the miss word
    (bit 25) once the path has ended (``render.WORD_*``).  The blockwise
    gradient kernel replays these winners.

    ``count`` traces the frame's pixels ``pix0 .. pix0 + count - 1`` only
    (a shard of the frame; pixel ids, draws and jitter stay the frame's):
    the sum is then (count, 3) and the words (max_bounces, count), and a
    pixel at or past ``width * height`` gives zeros and the miss word.
    """
    ns, npl, nb = counts
    out = render_tile_plain(spheres[:ns, :10], planes[:npl, :10], boxes[:nb, :12], cam, seeds,
                            size=size, spp=spp, max_bounces=max_bounces,
                            center_sample=center_sample, rng_mode=rng_mode, words=words,
                            pix0=pix0, count=count)
    return (out[0][0], out[1]) if words else out[0]


@functools.cache
def _kernel():
    from ._build import load_library

    fn = load_library("blockwise_kernel").rt_blockwise_forward
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, p, p, p, i, i, i, i, f, f, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _words_kernel():
    from ._build import load_library

    fn = load_library("blockwise_kernel").rt_blockwise_forward_words
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, p, p, p, p, i, i, i, i, f, f, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def render_blockwise_tile(spheres, planes, boxes, counts, cam, seeds, *, size, spp, max_bounces,
                          center_sample, rng_mode="reference", words=False, pix0=0, count=None):
    """One call of the blockwise kernel; arguments and result as
    :func:`render_blockwise_tile_plain` (``words=True``: the kernel's words
    form; ``count``: the pixels ``pix0 .. pix0 + count - 1`` only).  CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (without synchronizing) or raise."""
    fn = "render_blockwise_tile"
    dev = cam.device
    for name, t in (("spheres", spheres), ("planes", planes), ("boxes", boxes), ("seeds", seeds)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device} but cam on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if dev.type == "cpu":
        return render_blockwise_tile_plain(spheres, planes, boxes, counts, cam, seeds, size=size,
                                           spp=spp, max_bounces=max_bounces,
                                           center_sample=center_sample, rng_mode=rng_mode,
                                           words=words, pix0=pix0, count=count)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    w, h = size
    cols = w * h if count is None else count
    ns, npl, nb = counts
    _check_tables(fn, (spheres, planes, boxes), counts, dev)
    if spheres.data_ptr() % 16:
        raise ValueError(f"{fn}: the sphere table must be 16-byte aligned (float4 rows)")
    _check(fn, "cam", cam, torch.float32, (16,), dev)
    _check(fn, "seeds", seeds, torch.int32, (1,), dev)
    if w < 1 or h < 1 or w * h * 3 >= 2**31:
        raise ValueError(f"{fn}: bad size {w}x{h}")
    if cols < 1 or pix0 < 0 or (pix0 + cols) * 3 >= 2**31:
        raise ValueError(f"{fn}: bad pixels {pix0}..{pix0 + cols - 1}")
    if spp < 1 or max_bounces < 0 or (words and spp != 1):
        raise ValueError(f"{fn}: bad spp={spp} / max_bounces={max_bounces}"
                         + (" (words=True takes one sample)" if words else ""))
    if words and cols * max(max_bounces, 1) >= 2**31:
        raise ValueError(f"{fn}: {cols} x {max_bounces} winner words overflow int32 indexing")
    out = torch.empty((h, w, 3) if count is None else (cols, 3), dtype=torch.float32, device=dev)
    inv_w, inv_h = _inv_size(w, h)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if words:
            wd = torch.empty((max_bounces, cols), dtype=torch.int32, device=dev)
            err = _words_kernel()(
                spheres.data_ptr(), ns, planes.data_ptr(), npl, boxes.data_ptr(), nb,
                cam.data_ptr(), seeds.data_ptr(), out.data_ptr(), wd.data_ptr(), w, h, pix0,
                cols, inv_w, inv_h, max_bounces, int(bool(center_sample)),
                int(rng_mode == "sphere"), stream)
        else:
            err = _kernel()(
                spheres.data_ptr(), ns, planes.data_ptr(), npl, boxes.data_ptr(), nb,
                cam.data_ptr(), seeds.data_ptr(), out.data_ptr(), w, h, pix0, cols, inv_w, inv_h,
                spp, max_bounces, int(bool(center_sample)), int(rng_mode == "sphere"), stream)
    if err != 0:
        raise RuntimeError(f"blockwise kernel launch failed: CUDA error {err}")
    render_blockwise_tile.launches += 1
    return (out, wd) if words else out


render_blockwise_tile.launches = 0


def render_forward_blockwise(
    scene,
    size: tuple[int, int],
    seed: int = 0,
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    gamma: bool = True,
    rng_mode: str = "reference",
    include_boxes: bool = False,
    device="cuda",
    mesh=None,
    axis: str = "rays",
) -> torch.Tensor:
    """Render a full frame with the blockwise kernel.  Returns (H, W, 3)
    float32 on ``device``.

    ``include_boxes`` traces the box slab test too (the ``--boxes``
    extension).  With ``device="cpu"`` the plain PyTorch version renders.
    With ``mesh`` (a :func:`rt_tpu_torch.dist.make_mesh` mesh) the pixels
    are sharded over ``mesh[axis]``: :func:`render_forward_blockwise_sharded`.
    """
    from ..dist import mesh_axis, shard_range

    if not blockwise_supported(scene, include_boxes):
        raise ValueError("scene exceeds the blockwise kernel's limits "
                         f"({MAX_BLOCKWISE_PRIMS} primitives)")
    dev = _device(device)
    w, h = size
    spp = scene.samples_per_pixel if spp is None else spp
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    ax = None if mesh is None else mesh_axis(mesh, axis)
    pixels = {} if ax is None else dict(zip(("pix0", "count"), shard_range(w * h, ax, 128)))
    spheres, planes, boxes, counts = _padded_tables(scene, personality, include_boxes, dev)

    def launch(cam, seeds, k, center):
        return render_blockwise_tile(spheres, planes, boxes, counts, cam, seeds, size=size,
                                     spp=k, max_bounces=max_bounces, center_sample=center,
                                     rng_mode=rng_mode, **pixels)

    cam = _upload(_pack_camera(scene.camera, size), dev)
    # ops.render's, looked up at each call as render_forward looks it up: one
    # frame assembly for every forward route
    frame = _render._chunked_frame(launch, cam, seed, spp, 1, gamma, dev)
    return frame if ax is None else ax.all_gather(frame)[:w * h].reshape(h, w, 3)


def render_forward_blockwise_sharded(scene, size: tuple[int, int], mesh, seed: int = 0, *,
                                     axis: str = "rays", **opts) -> torch.Tensor:
    """:func:`render_forward_blockwise` (its ``opts``) sharded over
    ``mesh[axis]`` (a :func:`rt_tpu_torch.dist.make_mesh` mesh): the whole
    (H, W, 3) frame on every rank, equal bit for bit to the unsharded frame.

    Rank r covers the pixels ``[r * L, (r + 1) * L)``, L the pixel count
    over the axis rounded up to JAX's 128-pixel tiles (the last shard is
    padded); its kernel launches take that first pixel and count, so pixel
    ids, jitter and draws stay global (the TPU kernel's tile offset).  The
    tables and the camera are replicated; each rank's frame slice is
    gathered over ``axis`` and cut to the frame."""
    return render_forward_blockwise(scene, size, seed, mesh=mesh, axis=axis, **opts)


# ---------------------------------------------------------------------------
# the blockwise record kernel: one sample per pixel and the replay records
# ---------------------------------------------------------------------------


def render_record_blockwise_tile_plain(spheres, planes, boxes, counts, cam, seeds, *, size,
                                       max_bounces, center_sample, rng_mode="reference"):
    """Plain PyTorch version of the blockwise record kernel, on the device
    of ``cam``: the tables and counts of :func:`render_blockwise_tile_plain`,
    the result of :func:`rt_tpu_torch.ops.render.render_record_tile_plain`
    at the one seed ``seeds[0]``, its radiance (H, W, 3) (``idx`` is the
    table row, which is the scene index: the JAX record
    kernel scans without cull or Morton order).  It follows the JAX
    blockwise record kernel (pallas_blockwise.py:1565-1661, whose record
    math is ``_bounce_once``'s ``want_record="replay"``, :1034-1059) where
    the two JAX record kernels differ on lanes that the replay never reads:
    the reflect bit is computed on every lane whatever the tables hold,
    and the root bit of a lane that no sphere won is that of an all-zero
    sphere row."""
    ns, npl, nb = counts
    rows = (planes[:npl, :10].tolist(), spheres[:ns, :10].tolist(), boxes[:nb, :12].tolist())
    rad, recs = _record_plain(rows, cam, seeds[:1], size=size, max_bounces=max_bounces,
                              center_sample=center_sample, rng_mode=rng_mode, replay="blockwise")
    return rad[0], recs


def _record_pointers(rad, recs):
    return [rad.data_ptr()] + [recs[k].data_ptr() for k in RECORD_KEYS + ("jitter",)]


@functools.cache
def _record_kernel():
    from ._build import load_library

    fn = load_library("blockwise_kernel").rt_blockwise_record
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, f, f, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def render_record_blockwise_tile(spheres, planes, boxes, counts, cam, seeds, *, size, max_bounces,
                                 center_sample, rng_mode="reference"):
    """One launch of the blockwise record kernel; arguments and result as
    :func:`render_record_blockwise_tile_plain`.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream (without
    synchronizing) or raise."""
    fn = "render_record_blockwise_tile"
    dev = cam.device
    for name, t in (("spheres", spheres), ("planes", planes), ("boxes", boxes), ("seeds", seeds)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device} but cam on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if dev.type == "cpu":
        return render_record_blockwise_tile_plain(spheres, planes, boxes, counts, cam, seeds,
                                                  size=size, max_bounces=max_bounces,
                                                  center_sample=center_sample, rng_mode=rng_mode)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    w, h = size
    ns, npl, nb = counts
    _check_tables(fn, (spheres, planes, boxes), counts, dev)
    if spheres.data_ptr() % 16:
        raise ValueError(f"{fn}: the sphere table must be 16-byte aligned (float4 rows)")
    _check(fn, "cam", cam, torch.float32, (16,), dev)
    _check(fn, "seeds", seeds, torch.int32, (1,), dev)
    if w < 1 or h < 1 or max_bounces < 0 or w * h * max(max_bounces, 3) >= 2**31:
        raise ValueError(f"{fn}: bad size {w}x{h} or max_bounces={max_bounces}")
    _, rad, recs = _record_outputs(w, h, max_bounces, 1, dev)
    inv_w, inv_h = _inv_size(w, h)
    with torch.cuda.device(dev):
        err = _record_kernel()(
            spheres.data_ptr(), ns, planes.data_ptr(), npl, boxes.data_ptr(), nb,
            cam.data_ptr(), seeds.data_ptr(), *_record_pointers(rad, recs), w, h, inv_w, inv_h,
            max_bounces, int(bool(center_sample)), int(rng_mode == "sphere"),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blockwise record kernel launch failed: CUDA error {err}")
    render_record_blockwise_tile.launches += 1
    return rad[0], recs


render_record_blockwise_tile.launches = 0


def render_record_blockwise(scene, size, seed: int, *, personality: str = "mg",
                            max_bounces: Optional[int] = None, rng_mode: str = "reference",
                            center_sample: bool = True, include_boxes: bool = False,
                            device="cuda"):
    """One sample per pixel through the blockwise record kernel (the
    counterpart of ``pallas_blockwise.render_record_blockwise``): the
    record pass for scenes past the render kernel's 640 primitives.
    Returns ``(rad, recs)`` on ``device``, as
    :func:`rt_tpu_torch.ops.render.render_record`."""
    if not blockwise_supported(scene, include_boxes):
        raise ValueError("scene exceeds the blockwise megakernel limits")
    dev = _device(device)
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    spheres, planes, boxes, counts = _padded_tables(scene, personality, include_boxes, dev)
    return render_record_blockwise_tile(
        spheres, planes, boxes, counts, _upload(_pack_camera(scene.camera, size), dev),
        _upload(np.asarray([seed], np.int32), dev), size=size, max_bounces=max_bounces,
        center_sample=center_sample, rng_mode=rng_mode)
