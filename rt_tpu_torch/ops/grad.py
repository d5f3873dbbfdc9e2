"""Fused forward+backward MSE training step (port of
``rt_tpu.ops.pallas_grad``'s ``make_mse_step`` and
``pallas_mse_loss_and_grad``).

Two CUDA kernels of ``csrc/grad_kernel.cu`` carry it, one source for the
two TPU kernels they replace (their device math is shared; see the source
comment for what bounds them on the card):

* :func:`mse_step_tile` — ``_make_mono_kernel``: the whole step, every
  sample's forward sweep, the loss and pixel cotangent against the target,
  and every reverse sweep, in one launch.
* :func:`grad_tile` — ``_make_grad_kernel``: one sample's forward and
  reverse sweep, fed a pixel cotangent.  The per-sample route
  (``mode="multi"``) runs the render kernel once per sample for the frame,
  takes the loss and cotangent with torch, and then this kernel once per
  sample.

Beside each wrapper is its plain PyTorch version (:func:`mse_step_tile_plain`,
:func:`grad_tile_plain`), dense over pixels and written with the per-ray
math of :mod:`._grad_math`.  A CPU tensor goes to the plain version, a
CUDA tensor to the kernel; nothing falls back from one to the other.

The step returns ``(loss, grads)`` with ``grads`` keyed like
:func:`rt_tpu_torch.diff.extract_params`, as the JAX step does; it is not
an autograd function.  The router sends a step where the JAX router
would, so both compute the same function: the mono kernel while the
scene has at most ``MAX_GRAD_PRIMS`` primitives and the JAX mono stash
fits its budget at some tile height, else the per-sample route.  The TPU
knobs (tile rows, stash layouts, RNG implementation, interpret mode, cost
split switches) have no counterpart, and ``mode="chunked"`` (a measured
negative on the TPU) is not ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..diff import apply_params
from . import _grad_math as gm
from .render import MAX_UNROLL_PRIMS, _inv_size, hash_u01, render_tile
from .tables import _check, _device, _pack_camera, _unrolled_tables, _upload

__all__ = ["MAX_GRAD_PRIMS", "MAX_GRAD_PRIMS_LEAN", "grad_supported", "route",
           "mse_step_tile", "mse_step_tile_plain", "grad_tile", "grad_tile_plain",
           "make_mse_step", "mse_loss_and_grad"]

# the JAX router's thresholds (pallas_grad.py:168-169, 2092-2112): scenes
# past MAX_GRAD_PRIMS take the per-sample route, past MAX_GRAD_PRIMS_LEAN
# none; the mono route holds while (arrays per (sample, bounce)) x rows x
# 128 x 4 B x bounces x spp stays within 4.2 MB for some rows in 32..8
MAX_GRAD_PRIMS = 96
MAX_GRAD_PRIMS_LEAN = 640
_STASH_ARRAYS = 8        # the JAX default layout (slim stash, hash RNG)
_STASH_BUDGET_MB = 4.2
_THREADS = 128           # threads per block of the kernels (one partial per block)


def grad_supported(scene) -> bool:
    """Whether the fused step takes this scene (``pallas_grad_supported``)."""
    return scene.spheres.count + scene.planes.count <= MAX_GRAD_PRIMS_LEAN


def route(n_prims: int, spp: int, max_bounces: int, mode: str = "mono") -> str:
    """``"mono"`` or ``"multi"``: the JAX router's choice for a scene of
    ``n_prims`` primitives (pallas_grad.py:2235-2271)."""
    if mode == "chunked":
        raise ValueError("mode='chunked' is not ported (a measured negative on the TPU); "
                         "use 'mono' or 'multi'")
    if mode not in ("mono", "multi"):
        raise ValueError(f"unknown mode {mode!r}")
    if n_prims > MAX_GRAD_PRIMS_LEAN:
        raise ValueError("scene exceeds the fused grad kernel limits "
                         f"({MAX_GRAD_PRIMS_LEAN} primitives)")
    if mode == "mono" and n_prims > MAX_GRAD_PRIMS:
        return "multi"
    if mode == "mono":
        fits = [_STASH_ARRAYS * rows * 128 * 4 * max_bounces * spp / 2**20 <= _STASH_BUDGET_MB
                for rows in (32, 24, 16, 8)]
        if not any(fits):
            return "multi"
    return mode


def _sample_seeds(seed0: int, spp: int) -> np.ndarray:
    """Per-sample seeds ``seed0 * 100003 + s`` in wrapping int32 arithmetic
    (pallas_grad.py:2376, 2548)."""
    return np.asarray([((seed0 * 100003 + s + 2**31) % 2**32) - 2**31 for s in range(spp)],
                      np.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _fused_plain(spheres, planes, cam, seeds, pix_in, *, size, max_bounces, center0, rng_mode,
                 mono, with_l1, words=None, pix0=0, count=None):
    """The kernels' function, dense over pixels.  ``pix_in`` is the target
    (``mono``) or the pixel cotangent, (H, W, 3).  Returns the loss sum
    (``mono``), the sphere slots (9, S), the plane material slots (5, P)
    and the camera cotangent (16,); with ``with_l1`` also, per output, the
    sum of the absolute per-(pixel, sample) contributions.  ``words``
    ((max_bounces, H*W) int32, one sample: the blockwise gradient kernel's
    form) takes each bounce's winner from the forward kernel's winner words
    (``_grad_math.replay_winner``) in place of the scan.  ``count`` (with
    ``words``: a shard of the frame) runs the pixels ``pix0 .. pix0 + count
    - 1`` only, ``pix_in`` and ``words`` being theirs; a pixel at or past
    ``width * height`` adds nothing."""
    w, h = size
    dev = cam.device
    f32 = torch.float32
    S, P = spheres.shape[0], planes.shape[0]
    if count is None:
        n = w * h
        idx = torch.arange(n, device=dev, dtype=torch.int64)
    else:
        n = count
        idx = torch.arange(pix0, pix0 + count, device=dev, dtype=torch.int64)
    inside = idx < w * h
    px = (idx % w).to(f32)
    py = (idx // w).to(f32)
    inv_w, inv_h = _inv_size(w, h)
    c = cam.tolist()
    rng_sphere = rng_mode == "sphere"
    spp = seeds.shape[0]
    seed_list = seeds.tolist()
    zero = torch.zeros(n, dtype=f32, device=dev)

    img = [zero, zero, zero]
    sweeps = []
    for s, seed in enumerate(seed_list):
        jx, jy = hash_u01(idx, seed, 1), hash_u01(idx, seed, 2)
        if s == 0 and center0:
            jx = jy = 0.5
        o3, d3 = gm.raygen(c, px, py, jx, jy, inv_w, inv_h)
        thr3 = (zero + 1.0,) * 3
        live = inside
        stash = []
        for b in range(max_bounces):
            u3 = gm.unit_draws(idx, seed, 3 + 4 * b, rng_sphere)
            coin = hash_u01(idx, seed, 6 + 4 * b)
            if words is None:
                best, bidx, ispl, root = gm.scan(spheres, planes, o3, d3)
            else:
                best, bidx, ispl, root = gm.replay_winner(spheres, planes, o3, d3, words[b])
            pay, cls = gm.payload(spheres, planes, best < 1e37, ispl, bidx)
            o_n, d_n, thr_n, rad, bits = gm.bounce_forward(o3, d3, thr3, best, pay, cls, ispl,
                                                           root, live, u3, coin)
            stash.append((o3, d3, thr3, pay, u3, bits, bidx))
            img = [img[k] + rad[k] for k in range(3)]
            o3, d3, thr3, live = o_n, d_n, thr_n, bits["alive"]
        sweeps.append((jx, jy, stash))

    pix = pix_in.reshape(n, 3)
    loss = loss_l1 = None
    if mono:
        inv_spp = float(np.float32(1.0 / spp))
        cot_scale = float(np.float32(2.0 / (3.0 * w * h * spp)))
        diff = [img[k] * inv_spp - pix[:, k] for k in range(3)]
        per_px = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        loss = loss_l1 = per_px.sum()
        crad = tuple(d * cot_scale for d in diff)
    else:
        crad = tuple(torch.where(inside, pix[:, k], 0.0) for k in range(3))

    sg = torch.zeros((9, S), dtype=f32, device=dev)
    pg = torch.zeros((5, P), dtype=f32, device=dev)
    cg = torch.zeros(16, dtype=f32, device=dev)
    sg_l1, pg_l1, cg_l1 = sg.clone(), pg.clone(), cg.clone()
    for jx, jy, stash in sweeps:
        co = cd = ct = (zero, zero, zero)
        for o3, d3, thr3, pay, u3, bits, bidx in reversed(stash):
            co, cd, ct, slots = gm.bounce_adjoint(o3, d3, thr3, pay, u3, bits, co, cd, ct, crad)
            live_h = bits["live_h"]
            for acc, acc_l1, m, vs in ((sg, sg_l1, live_h & ~bits["ispl"], slots),
                                       (pg, pg_l1, live_h & bits["ispl"], slots[4:])):
                # one masked torch.sum per primitive: a tree reduction,
                # accurate to float rounding (an index_add_ of every ray
                # into one slot is a long serial sum on the card)
                vals = torch.stack([torch.where(m, v, 0.0) for v in vs])
                for i in bidx[m].unique().tolist():
                    sel = bidx == i
                    acc[:, i] += torch.where(sel, vals, 0.0).sum(dim=1)
                    acc_l1[:, i] += torch.where(sel, vals.abs(), 0.0).sum(dim=1)
        cam_cot = torch.where(inside, torch.stack(gm.raygen_adjoint(c, px, py, jx, jy, inv_w,
                                                                     inv_h, co, cd)), 0.0)
        cg[:15] += cam_cot.sum(dim=1)
        cg_l1[:15] += cam_cot.abs().sum(dim=1)

    out = (sg, pg, cg) if loss is None else (loss, sg, pg, cg)
    if not with_l1:
        return out
    l1 = (sg_l1, pg_l1, cg_l1) if loss is None else (loss_l1, sg_l1, pg_l1, cg_l1)
    return out, l1


def mse_step_tile_plain(spheres, planes, cam, seeds, target, *, size, max_bounces,
                        rng_mode="reference", with_l1=False):
    """Plain PyTorch version of the mono kernel, on the device of ``cam``.

    Args:
      spheres, planes: (S, 10) / (P, 10) float32 rows
        (``tables._unrolled_tables``).
      cam: (16,) float32 camera vector; seeds: (spp,) int32, one per sample
        (sample 0 at the pixel centre).
      target: (H, W, 3) float32 pre-gamma target.

    Returns ``(loss_sum, sg, pg, cg)``: the sum over pixels of the squared
    error of the spp-mean (times 1/(3 W H) it is the MSE), the sphere
    gradient slots (9, S) — centre x/y/z, radius, albedo r/g/b,
    reflectivity, roughness —, the plane material slots (5, P) and the
    camera cotangent (16,).  ``with_l1=True`` returns ``(result, l1)``,
    where ``l1`` holds, per entry, the sum of the absolute per-(pixel,
    sample) contributions: the scale of the kernel's summation error.
    """
    return _fused_plain(spheres, planes, cam, seeds, target, size=size, max_bounces=max_bounces,
                        center0=True, rng_mode=rng_mode, mono=True, with_l1=with_l1)


def grad_tile_plain(spheres, planes, cam, seeds, cot, *, size, max_bounces, center_sample,
                    rng_mode="reference", with_l1=False):
    """Plain PyTorch version of the per-sample kernel: one sample (seeds
    (1,) int32; ``center_sample`` puts it at the pixel centre) fed the
    pixel cotangent ``cot`` (H, W, 3).  Returns ``(sg, pg, cg)`` as
    :func:`mse_step_tile_plain` (and ``l1`` with ``with_l1``)."""
    return _fused_plain(spheres, planes, cam, seeds, cot, size=size, max_bounces=max_bounces,
                        center0=center_sample, rng_mode=rng_mode, mono=False, with_l1=with_l1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    from ._build import load_library

    fn = load_library("grad_kernel").rt_grad_fused
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, p, i, p, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, spheres, planes, cam, seeds, pix_in, *, size, max_bounces, center0, rng_mode,
            mono):
    dev = cam.device
    w, h = size
    f32 = torch.float32
    for name, t in (("spheres", spheres), ("planes", planes), ("seeds", seeds),
                    ("target" if mono else "cot", pix_in)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device} but cam on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    _check(fn, "spheres", spheres, f32, (None, 10), dev)
    _check(fn, "planes", planes, f32, (None, 10), dev)
    _check(fn, "cam", cam, f32, (16,), dev)
    _check(fn, "seeds", seeds, torch.int32, (None if mono else 1,), dev)
    _check(fn, "target" if mono else "cot", pix_in, f32, (h, w, 3), dev)
    S, P, spp = spheres.shape[0], planes.shape[0], seeds.shape[0]
    if S + P > MAX_UNROLL_PRIMS:
        raise ValueError(f"{fn}: more than {MAX_UNROLL_PRIMS} primitives")
    n = w * h
    if w < 1 or h < 1 or spp < 1 or n * 3 >= 2**31 or max_bounces < 0:
        raise ValueError(f"{fn}: bad size {w}x{h}, spp={spp} or max_bounces={max_bounces}")
    blocks = -(-n // _THREADS)
    loss = torch.empty(blocks, dtype=f32, device=dev) if mono else None
    sg = torch.empty((blocks, 9, S), dtype=f32, device=dev)
    pg = torch.empty((blocks, 5, P), dtype=f32, device=dev)
    cg = torch.empty((blocks, 16), dtype=f32, device=dev)
    # the stash: per (sample, bounce) 9 floats and a packed word per pixel,
    # and each sample's live-bounce count
    st_f = torch.empty(spp * max_bounces * 9 * n, dtype=f32, device=dev)
    st_w = torch.empty(spp * max_bounces * n, dtype=torch.int32, device=dev)
    st_nb = torch.empty(spp * n, dtype=torch.int32, device=dev)
    inv_w, inv_h = _inv_size(w, h)
    inv_spp = float(np.float32(1.0 / spp))
    cot_scale = float(np.float32(2.0 / (3.0 * w * h * spp)))
    with torch.cuda.device(dev):
        err = _kernel()(
            int(mono), spheres.data_ptr(), S, planes.data_ptr(), P, cam.data_ptr(),
            seeds.data_ptr(), pix_in.data_ptr(), loss.data_ptr() if mono else None,
            sg.data_ptr(), pg.data_ptr(), cg.data_ptr(), st_f.data_ptr(), st_w.data_ptr(),
            st_nb.data_ptr(), w, h, spp, max_bounces, int(bool(center0)),
            int(rng_mode == "sphere"), inv_w, inv_h, inv_spp, cot_scale,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grad kernel launch failed: CUDA error {err}")
    out = (sg.sum(dim=0), pg.sum(dim=0), cg.sum(dim=0))
    return out if not mono else (loss.sum(),) + out


def mse_step_tile(spheres, planes, cam, seeds, target, *, size, max_bounces,
                  rng_mode="reference"):
    """One launch of the mono kernel; arguments and result as
    :func:`mse_step_tile_plain`.  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream (without
    synchronizing) or raise."""
    kw = dict(size=size, max_bounces=max_bounces, rng_mode=rng_mode)
    out = _launch("mse_step_tile", spheres, planes, cam, seeds, target, center0=True,
                  mono=True, **kw)
    if out is None:
        return mse_step_tile_plain(spheres, planes, cam, seeds, target, **kw)
    mse_step_tile.launches += 1
    return out


def grad_tile(spheres, planes, cam, seeds, cot, *, size, max_bounces, center_sample,
              rng_mode="reference"):
    """One launch of the per-sample kernel; arguments and result as
    :func:`grad_tile_plain`.  CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream or raise."""
    kw = dict(size=size, max_bounces=max_bounces, rng_mode=rng_mode)
    out = _launch("grad_tile", spheres, planes, cam, seeds, cot, center0=center_sample,
                  mono=False, **kw)
    if out is None:
        return grad_tile_plain(spheres, planes, cam, seeds, cot, center_sample=center_sample,
                               **kw)
    grad_tile.launches += 1
    return out


mse_step_tile.launches = 0
grad_tile.launches = 0


# ---------------------------------------------------------------------------
# gradient bookkeeping and entry points
# ---------------------------------------------------------------------------


def _assemble_grads(sg, pg, cg, s_mat, p_mat, S_table, M_table):
    """Per-primitive gradient slots -> the extract_params-keyed dict
    (pallas_grad ``_assemble_grads``; ``index_add_`` where JAX uses
    ``.at[].add``).  ``pg`` holds the plane material slots only."""
    dev, f32 = cg.device, torch.float32
    ns, npl = s_mat.shape[0], p_mat.shape[0]
    g_center = torch.zeros((S_table, 3), dtype=f32, device=dev)
    g_radius = torch.zeros(S_table, dtype=f32, device=dev)
    g_alb = torch.zeros((M_table, 4), dtype=f32, device=dev)
    g_refl = torch.zeros(M_table, dtype=f32, device=dev)
    g_rough = torch.zeros(M_table, dtype=f32, device=dev)
    for mat, slots, count in ((s_mat, sg[4:9], ns), (p_mat, pg, npl)):
        if not count:
            continue
        for k in range(3):
            g_alb[:, k].index_add_(0, mat, slots[k, :count])
        g_refl.index_add_(0, mat, slots[3, :count])
        g_rough.index_add_(0, mat, slots[4, :count])
    if ns:
        g_center[:ns] = sg[0:3, :ns].T
        g_radius[:ns] = sg[3, :ns]
    return {
        "spheres.center": g_center,
        "spheres.radius": g_radius,
        "materials.albedo": g_alb,
        "materials.roughness": g_rough,
        "materials.reflectivity": g_refl,
        "camera.position": cg[0:3],
        "camera.rotation": cg[3:12].reshape(3, 3),
    }


def _pad_missing_grads(grads, params, device):
    """Zero gradients for the param keys the kernels do not cover (boxes
    of the ``--boxes`` extension, which the tracer never hits), so the
    gradient dict has every key of ``params``."""
    out = dict(grads)
    for k, v in params.items():
        if k not in out:
            out[k] = torch.zeros(tuple(v.shape), dtype=v.dtype, device=device)
    return out


def make_mse_step(
    params,
    scene,
    target,
    size: tuple[int, int],
    *,
    spp: int = 4,
    max_bounces: Optional[int] = None,
    personality: str = "mg",
    rng_mode: str = "reference",
    mode: str = "mono",
    device="cuda",
):
    """Prebuilt fwd+bwd step: ``step(seed) -> (loss, grads)``.

    ``params`` (a dict of tensors, as :func:`rt_tpu_torch.diff.extract_params`
    gives) is substituted into ``scene`` once; the tables, camera and
    ``target`` ((H, W, 3) pre-gamma radiance) go to ``device`` once, and
    each call ships the per-sample seeds.  ``mode="mono"`` asks for the
    one-launch step and the router may still send the step to the
    per-sample route (as the JAX router does); ``mode="multi"`` asks for
    the per-sample route.  The loss is the MSE of the spp-mean image
    against the target; ``grads`` holds the detached-sampling gradient of
    every key of ``params`` (zero for boxes).
    """
    dev = _device(device)
    w, h = size
    n = w * h
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    concrete = apply_params(scene, params)
    mode = route(concrete.spheres.count + concrete.planes.count, spp, max_bounces, mode)

    spheres, planes, no_boxes = _unrolled_tables(concrete, personality, False, dev)
    cam = _upload(_pack_camera(concrete.camera, size), dev)
    tgt = torch.as_tensor(target, dtype=torch.float32).reshape(h, w, 3).to(dev).contiguous()
    s_mat = concrete.spheres.material[:concrete.spheres.count].to(device=dev, dtype=torch.int64)
    p_mat = concrete.planes.material[:concrete.planes.count].to(device=dev, dtype=torch.int64)
    tables = (scene.spheres.center.shape[0], scene.materials.albedo.shape[0])
    kw = dict(size=size, max_bounces=max_bounces, rng_mode=rng_mode)

    def step(seed: int = 0):
        seeds = _upload(_sample_seeds(seed, spp), dev)
        if mode == "mono":
            loss_sum, sg, pg, cg = mse_step_tile(spheres, planes, cam, seeds, tgt, **kw)
            loss = loss_sum * float(np.float32(1.0 / (3.0 * n)))
        else:
            total = None
            for s in range(spp):
                out = render_tile(spheres, planes, no_boxes, cam, seeds[s:s + 1], spp=1,
                                  center_sample=(s == 0), **kw)
                total = out if total is None else total + out
            diff = (total * float(np.float32(1.0 / spp)))[0] - tgt
            loss = torch.mean(diff ** 2)
            cot = 2.0 * diff / (3.0 * n * spp)
            sg = pg = cg = None
            for s in range(spp):
                g = grad_tile(spheres, planes, cam, seeds[s:s + 1], cot, center_sample=(s == 0),
                              **kw)
                sg, pg, cg = g if sg is None else (sg + g[0], pg + g[1], cg + g[2])
        grads = _assemble_grads(sg, pg, cg, s_mat, p_mat, *tables)
        return loss, _pad_missing_grads(grads, params, dev)

    step.mode = mode
    return step


def mse_loss_and_grad(params, scene, target, size, seed: int = 0, **kw):
    """``(loss, grads)`` of one fused step (:func:`make_mse_step`'s
    arguments; the counterpart of ``pallas_mse_loss_and_grad``)."""
    return make_mse_step(params, scene, target, size, **kw)(seed)
