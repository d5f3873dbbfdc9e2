"""Blockwise fused forward+backward: the MSE training step for scenes of up
to 16384 primitives, with tables rebuilt from the parameters every step
(port of ``rt_tpu.ops.pallas_blockwise_grad``).

The kernel (``csrc/bw_grad_kernel.cu``) is the per-sample gradient kernel
of ``ops.grad`` with its tables read from device memory, its per-row
gradients added straight into the step's gradient tables, and no scan: it
runs the reverse of one sample along the path that the sample's forward
launch recorded, taking each bounce's winner from that launch's winner
words (``render_blockwise_tile(words=True)``) and recomputing the hit with
the scan's own expressions on that one row.  With the forward launch it
computes what JAX's ``_make_bw_grad_kernel`` computes, which scans again
(its source comment says why the winners are the same and what bounds it).
Beside it:

* :func:`bw_grad_tile_plain` — the same function in plain PyTorch: one
  sample's forward sweep along the recorded winners
  (``_grad_math.replay_winner``), the reverse sweep through the
  hand-written adjoint of ``_bounce_smooth``, per-row gradient sums and the
  camera cotangent, fed a pixel cotangent — the sweep and adjoint of
  :func:`rt_tpu_torch.ops.grad.grad_tile_plain` on the used rows of the
  padded tables, with the winners from the words in place of the scan.
* :func:`bw_grad_tile` — the kernel wrapper; ``bw_grad_tile.launches``
  counts launches.  A CPU tensor goes to the plain version, a CUDA tensor
  to the kernel; nothing falls back from one to the other.
* :func:`make_bw_mse_step` / :func:`bw_mse_loss_and_grad` — ``(loss,
  grads)`` of one step at fixed params: ``spp`` one-sample launches of the
  blockwise forward kernel in its words form for the frame and the winner
  words, the MSE and the pixel cotangent in torch, then ``spp`` launches
  of the gradient kernel along those words, as ``_bw_grad_pipeline`` does
  with its rescanning kernel.  The words of all ``spp`` samples live
  together between the two sweeps: 66 MB a sample at 1920x1080, depth 8.  The loss comes from the forward kernel's
  frame (the render dielectric), the gradients from the gradient kernel's
  own sweep (the ``_bounce_forward`` dielectric), as in JAX.
* :func:`make_bw_train_step` — a whole optimizer step: tables rebuilt on
  the device from the parameter tensors (:func:`_tables_torch`), the fused
  step, ``.grad`` set for every key of ``params``, ``optimizer.step()``.
  A ``torch.optim`` optimizer stands in for optax (``torch.optim.Adam``
  for ``optax.adam``: same betas and eps; the two round the update in a
  different order, see tests/test_torch_blockwise_train.py).

Per-sample seeds are ``seed0 * 100003 + s`` in wrapping int32, unlike the
forward entry point's LCG chunk chain: both as in JAX.  The TPU knobs
(``block``, ``rng_impl="hw"``, ``interpret``) are not ported.  With
``mesh=`` the pipeline is the sharded one (``_bw_grad_pipeline_sharded``):
each rank's launches cover a contiguous pixel range of the frame.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..diff import apply_params
from ..materials import personality_classes
from ..profiling import span
from .blockwise import MAX_BLOCKWISE_PRIMS, _COLS, _bucket, _check_tables, render_blockwise_tile
from .grad import _assemble_grads, _check, _fused_plain, _sample_seeds
from .render import _device, _inv_size, _upload

__all__ = ["bw_grad_supported", "bw_grad_tile", "bw_grad_tile_plain", "make_bw_mse_step",
           "bw_mse_loss_and_grad", "make_bw_train_step"]


def bw_grad_supported(scene) -> bool:
    """Whether the blockwise gradient step takes this scene: at most
    ``MAX_BLOCKWISE_PRIMS`` spheres and planes, and no boxes."""
    return (scene.spheres.count + scene.planes.count <= MAX_BLOCKWISE_PRIMS
            and scene.boxes.count == 0)


def bw_grad_tile_plain(spheres, planes, counts, cam, seeds, cot, words, *, size, max_bounces,
                       center_sample, rng_mode="reference", with_l1=False, pix0=0, count=None):
    """Plain PyTorch version of the kernel, on the device of ``cam``: the
    reverse of one sample along the path that the forward launch recorded.

    Args:
      spheres, planes: padded (rows, 16) float32 tables
        (``blockwise._padded_table``); counts: (n_spheres, n_planes), their
        used rows.
      cam: (16,) float32 camera vector; seeds: (1,) int32, the sample's
        seed (``center_sample`` puts it at the pixel centre).
      cot: (H, W, 3) float32 pixel cotangent.
      words: (max_bounces, H*W) int32, the winner words of the same
        sample's forward launch (``render_blockwise_tile(words=True)``).

    Returns ``(sg, pg, cg)``: the sphere gradient slots (9, n_spheres) —
    centre x/y/z, radius, albedo r/g/b, reflectivity, roughness —, the
    plane material slots (5, n_planes) and the camera cotangent (16,).
    ``with_l1=True`` returns ``(result, l1)`` as ``grad.grad_tile_plain``,
    whose sweep and adjoint this is, with each bounce's winner taken from
    ``words`` (``_grad_math.replay_winner``) in place of the scan: the same
    winners wherever the two sweeps trace the same path (the module note).

    ``count`` runs the frame's pixels ``pix0 .. pix0 + count - 1`` only (a
    shard of the frame, as the forward launch's ``count``): ``cot`` is then
    (count, 3) and ``words`` (max_bounces, count), and a pixel at or past
    ``width * height`` adds nothing.
    """
    ns, npl = counts
    return _fused_plain(spheres[:ns, :10], planes[:npl, :10], cam, seeds, cot, size=size,
                        max_bounces=max_bounces, center0=center_sample, rng_mode=rng_mode,
                        mono=False, with_l1=with_l1, words=words, pix0=pix0, count=count)


@functools.cache
def _kernel():
    from ._build import load_library

    fn = load_library("bw_grad_kernel").rt_bw_grad
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def bw_grad_tile(spheres, planes, counts, cam, seeds, cot, words, *, size, max_bounces,
                 center_sample, rng_mode="reference", out=None, pix0=0, count=None):
    """One launch of the blockwise gradient kernel; arguments and result as
    :func:`bw_grad_tile_plain`, but float64: the kernel adds each ray's
    contribution to the gradient tables with atomics, in float64 so that
    their varying order does not show (csrc/bw_grad_kernel.cu).  With
    ``out=(sg, pg, cg)`` (float64) the sample's gradients are added to those
    tensors, which are returned.  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream (without synchronizing)
    or raise."""
    fn = "bw_grad_tile"
    dev = cam.device
    for name, t in (("spheres", spheres), ("planes", planes), ("seeds", seeds), ("cot", cot),
                    ("words", words)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device} but cam on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    w, h = size
    ns, npl = counts
    shapes = ((9, ns), (5, npl), (16,))
    if out is not None:
        for name, t, shape in zip(("sg", "pg", "cg"), out, shapes):
            _check(fn, name, t, torch.float64, shape, dev)
    if dev.type == "cpu":
        got = bw_grad_tile_plain(spheres, planes, counts, cam, seeds, cot, words, size=size,
                                 max_bounces=max_bounces, center_sample=center_sample,
                                 rng_mode=rng_mode, pix0=pix0, count=count)
        if out is None:
            return tuple(g.double() for g in got)
        for o, g in zip(out, got):
            o += g
        return out
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    _check_tables(fn, (spheres, planes), counts, dev)
    _check(fn, "cam", cam, torch.float32, (16,), dev)
    _check(fn, "seeds", seeds, torch.int32, (1,), dev)
    n = w * h if count is None else count
    _check(fn, "cot", cot, torch.float32, (h, w, 3) if count is None else (n, 3), dev)
    _check(fn, "words", words, torch.int32, (max_bounces, n), dev)
    if w < 1 or h < 1 or w * h * 3 >= 2**31 or max_bounces < 0:
        raise ValueError(f"{fn}: bad size {w}x{h} or max_bounces={max_bounces}")
    if n < 1 or pix0 < 0 or (pix0 + n) * 3 >= 2**31:
        raise ValueError(f"{fn}: bad pixels {pix0}..{pix0 + n - 1}")
    if out is None:
        out = tuple(torch.zeros(s, dtype=torch.float64, device=dev) for s in shapes)
    sg, pg, cg = out
    # the stash: per bounce 9 floats and a packed word per pixel, and the
    # live-bounce count
    st_f = torch.empty(max_bounces * 9 * n, dtype=torch.float32, device=dev)
    st_w = torch.empty(max_bounces * n, dtype=torch.int32, device=dev)
    st_nb = torch.empty(n, dtype=torch.int32, device=dev)
    inv_w, inv_h = _inv_size(w, h)
    with torch.cuda.device(dev):
        err = _kernel()(
            spheres.data_ptr(), ns, planes.data_ptr(), npl, cam.data_ptr(), seeds.data_ptr(),
            cot.data_ptr(), words.data_ptr(), sg.data_ptr(), pg.data_ptr(), cg.data_ptr(),
            st_f.data_ptr(),
            st_w.data_ptr(), st_nb.data_ptr(), w, h, pix0, n, max_bounces,
            int(bool(center_sample)),
            int(rng_mode == "sphere"), inv_w, inv_h, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blockwise grad kernel launch failed: CUDA error {err}")
    bw_grad_tile.launches += 1
    return out


bw_grad_tile.launches = 0


# ---------------------------------------------------------------------------
# tables and the pipeline
# ---------------------------------------------------------------------------


def _tables_torch(scene, personality: str, s_pad: int, p_pad: int, size, device):
    """The twin of ``_tables_jnp``: returns ``build(params) -> (s_tab,
    p_tab, cam)``, the padded (pad, 16) tables and the camera vector rebuilt
    on ``device`` from the parameter tensors with torch ops — no host round
    trip and no upload per call.  Material indices and classes, which never
    train, are looked up once here.  Column 10 stays zero, as in
    ``_tables_jnp``; ``build`` writes into the same two tables each call."""
    sc0 = scene.to(device)
    dev = sc0.spheres.center.device  # with its index
    w, h = size
    classes = personality_classes(personality).to(dev)
    ns, npl = scene.spheres.count, scene.planes.count
    s_m = sc0.spheres.material[:ns].long()
    p_m = sc0.planes.material[:npl].long()
    s_cls = classes[sc0.materials.type[s_m].long()].float()
    p_cls = classes[sc0.materials.type[p_m].long()].float()
    tail = _upload(np.asarray([np.tan(scene.camera.vfov * 0.5), w / h, scene.camera.near, 0.0],
                              np.float32), dev)
    s_tab = torch.zeros((s_pad, _COLS), dtype=torch.float32, device=dev)
    p_tab = torch.zeros((p_pad, _COLS), dtype=torch.float32, device=dev)

    def rows(geom, d, m, cls, mats):
        return torch.cat([geom, d[:, None], mats.albedo[m][:, :3], mats.reflectivity[m][:, None],
                          mats.roughness[m][:, None], cls[:, None]], dim=1)

    def build(params):
        for k, v in params.items():
            if v.device != dev:
                raise ValueError(f"param {k} is on {v.device}, the step on {dev}")
        with span("rt.tables"), torch.no_grad():
            sc = apply_params(sc0, {k: v.detach() for k, v in params.items()})
            if ns:
                s_tab[:ns, :10] = rows(sc.spheres.center[:ns], sc.spheres.radius[:ns], s_m,
                                       s_cls, sc.materials)
            if npl:
                p_tab[:npl, :10] = rows(sc.planes.normal[:npl], sc.planes.d[:npl], p_m, p_cls,
                                        sc.materials)
            cam = torch.cat([sc.camera.position.float(), sc.camera.rotation.float().reshape(-1),
                             tail])
        return s_tab, p_tab, cam

    return build


def _table_builder(scene, personality: str, size, dev):
    """:func:`_tables_torch` at the scene's buckets, once the scene passes
    :func:`bw_grad_supported`."""
    if not bw_grad_supported(scene):
        raise ValueError("scene exceeds the blockwise grad kernel limits "
                         f"({MAX_BLOCKWISE_PRIMS} spheres and planes, no boxes)")
    return _tables_torch(scene, personality, _bucket(scene.spheres.count),
                         _bucket(scene.planes.count), size, dev)


def _sum_over(axis, acc):
    """The float64 accumulators summed over the mesh axis (one flat
    all-reduce), or as they are without one."""
    if axis is None:
        return acc
    flat = axis.all_sum(torch.cat([a.reshape(-1) for a in acc]))
    return tuple(t.reshape(a.shape) for t, a in zip(flat.split([a.numel() for a in acc]), acc))


def _bw_pipeline(scene, target, size, *, spp, max_bounces, rng_mode, dev, mesh=None,
                 axis="rays"):
    """``_bw_grad_pipeline``'s body: ``run(s_tab, p_tab, cam, seed) ->
    (loss, grads)`` for tables of ``scene``'s shape.

    With ``mesh`` (``_bw_grad_pipeline_sharded``) each rank of
    ``mesh[axis]`` runs the forward launches and the gradient kernel over
    its contiguous pixel range (JAX's 128-pixel tiles, the last shard
    padded) against its slice of the cotangent, and the float64 gradient
    accumulators are summed over the axis before ``_assemble_grads``.  The
    ranks' frames are gathered and the loss and cotangent computed from
    the whole frame as without a mesh, so the loss is the unsharded
    step's bit for bit (JAX sums the ranks' squared errors instead)."""
    from ..dist import mesh_axis, shard_range

    w, h = size
    n = w * h
    f32 = torch.float32
    counts = (scene.spheres.count, scene.planes.count)
    s_mat = scene.spheres.material[:counts[0]].to(device=dev, dtype=torch.int64)
    p_mat = scene.planes.material[:counts[1]].to(device=dev, dtype=torch.int64)
    tables = (scene.spheres.center.shape[0], scene.materials.albedo.shape[0])
    tgt = torch.as_tensor(target, dtype=f32).reshape(h, w, 3).to(dev).contiguous()
    no_boxes = torch.zeros((0, _COLS), dtype=f32, device=dev)
    scale = float(np.float32(1.0 / spp))
    kw = dict(size=size, max_bounces=max_bounces, rng_mode=rng_mode)
    ax = None if mesh is None else mesh_axis(mesh, axis)
    if ax is not None:
        pix0, count = shard_range(n, ax, 128)
        kw.update(pix0=pix0, count=count)

    def run(s_tab, p_tab, cam, seed):
        seeds = _upload(_sample_seeds(seed, spp), dev)
        with span("rt.forward"):
            total = None
            words = []
            for s in range(spp):
                out, wd = render_blockwise_tile(s_tab, p_tab, no_boxes, (*counts, 0), cam,
                                                seeds[s:s + 1], spp=1, center_sample=(s == 0),
                                                words=True, **kw)
                words.append(wd)
                total = out if total is None else total + out
            if ax is not None:
                total = ax.all_gather(total)[:n].reshape(h, w, 3)
        with span("rt.loss"):
            diff = total * scale - tgt
            loss = torch.mean(diff ** 2)
            cot = 2.0 * diff / (3.0 * n * spp)
            if ax is not None:  # this rank's columns of the cotangent, zero past the frame
                cot = torch.cat([cot.reshape(n, 3), cot.new_zeros((count * ax.size - n, 3))])
                cot = cot[pix0:pix0 + count]
        with span("rt.reverse"):
            acc = tuple(torch.zeros(s, dtype=torch.float64, device=dev)
                        for s in ((9, counts[0]), (5, counts[1]), (16,)))
            for s in range(spp):
                bw_grad_tile(s_tab, p_tab, counts, cam, seeds[s:s + 1], cot, words[s],
                             center_sample=(s == 0), out=acc, **kw)
            acc = _sum_over(ax, acc)
            return loss, _assemble_grads(*(a.float() for a in acc), s_mat, p_mat, *tables)

    return run


def make_bw_mse_step(
    params,
    scene,
    target,
    size: tuple[int, int],
    *,
    spp: int = 4,
    max_bounces: Optional[int] = None,
    personality: str = "mg",
    rng_mode: str = "reference",
    device="cuda",
    mesh=None,
    axis: str = "rays",
):
    """Prebuilt fwd+bwd step at fixed ``params``: ``step(seed) -> (loss,
    grads)``.

    ``params`` (a dict of tensors, as :func:`rt_tpu_torch.diff.extract_params`
    gives, or a subset) go to ``device`` and the tables and camera are
    built there from them once (:func:`_tables_torch`, as the train step
    does); ``target`` ((H, W, 3) pre-gamma radiance) goes to ``device``
    once, and each call ships the per-sample seeds.  The loss is the MSE of
    the spp-mean frame against the target; ``grads`` holds the
    detached-sampling gradients of the scene's seven differentiable keys,
    as the JAX step returns them.  With ``mesh`` the pixels are sharded
    over ``mesh[axis]`` (:func:`_bw_pipeline`) and every rank returns the
    whole step's loss and gradients.
    """
    dev = _device(device)
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    build = _table_builder(scene, personality, size, dev)
    tables = build({k: torch.as_tensor(v).to(dev) for k, v in params.items()})
    run = _bw_pipeline(scene, target, size, spp=spp, max_bounces=max_bounces,
                       rng_mode=rng_mode, dev=dev, mesh=mesh, axis=axis)

    def step(seed: int = 0):
        return run(*tables, seed)

    return step


def bw_mse_loss_and_grad(params, scene, target, size, seed: int = 0, **kw):
    """``(loss, grads)`` of one blockwise fused step (:func:`make_bw_mse_step`'s
    arguments)."""
    return make_bw_mse_step(params, scene, target, size, **kw)(seed)


def make_bw_train_step(
    optimizer: torch.optim.Optimizer,
    scene,
    target,
    size: tuple[int, int],
    *,
    spp: int = 4,
    max_bounces: Optional[int] = None,
    personality: str = "mg",
    rng_mode: str = "reference",
    device="cuda",
    mesh=None,
    axis: str = "rays",
):
    """One optimizer step per call: ``step(params, seed) -> loss``.

    ``optimizer`` is a ``torch.optim`` optimizer built over the tensors of
    ``params`` (a dict keyed like :func:`rt_tpu_torch.diff.extract_params`,
    on ``device``).  Each call rebuilds the tables from ``params`` on the
    device, runs the fused step, sets ``.grad`` of every tensor of
    ``params`` and calls ``optimizer.step()``, which updates them in place.
    Nothing but the per-sample seeds goes to the device per call.

    ``target`` must be PRE-gamma radiance, as in every gradient pipeline.
    With ``mesh`` (a :func:`rt_tpu_torch.dist.make_mesh` mesh) the pixels
    are sharded over ``mesh[axis]`` and the gradients summed over it
    (``_bw_grad_pipeline_sharded``): every rank holds the same params and
    takes the same optimizer step, bit for bit.
    """
    dev = _device(device)
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    build = _table_builder(scene, personality, size, dev)
    run = _bw_pipeline(scene, target, size, spp=spp, max_bounces=max_bounces,
                       rng_mode=rng_mode, dev=dev, mesh=mesh, axis=axis)

    def step(params, seed: int):
        with span("rt.step", root=True):
            loss, grads = run(*build(params), seed)
            for k, p in params.items():
                p.grad = grads[k]
            optimizer.step()
            return loss

    return step
