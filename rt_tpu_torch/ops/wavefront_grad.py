"""Wavefront fused forward+backward: the MSE training step on the
bounce-major pipeline for scenes of up to 16384 primitives (port of
``rt_tpu.ops.pallas_wavefront_grad``).

The forward is :mod:`.wavefront`'s in record mode: per chunk, the table
each bounce entered and its winner words are kept, and the frame is
assembled from the final table (the record pass is the frame).  The
reverse runs one launch per bounce, from the last down to bounce 0,
through the kernel of ``csrc/wf_grad_kernel.cu``: no closest-hit scan, the
winner's payload fetched by its row, the decisions recomputed, the
hand-written adjoint of ``_bounce_smooth``.  Beside it:

* :func:`wf_rev_plain` — the kernel's function in plain PyTorch, dense over
  the rays of the saved table (the payload by ``_grad_math.payload``, the
  hit distance by :func:`_recompute_t`, then ``_grad_math.decisions`` and
  ``_grad_math.bounce_adjoint``), per-row sums with float64
  ``index_add_``.  It is the CPU path and the reference on the card.
* :func:`wf_rev` — the kernel wrapper; ``wf_rev.launches`` counts launches.
* :func:`make_wf_mse_step` / :func:`wf_mse_loss_and_grad` — ``(loss,
  grads)`` at fixed params; :func:`make_wf_train_step` — a whole optimizer
  step with a ``torch.optim`` optimizer, as ``make_bw_train_step``.  Both
  build the tables on the device from the params with the blockwise
  step's builder (``blockwise_grad._tables_torch``).

Cotangents in ray-id order.  JAX keeps its cotangent table in the layout of
the sorted state and carries it back through every sort with a recorded
permutation and one more sort (``_sort_state_perm``, ``_transport``).  Here
the cotangents of every ray's origin, direction and throughput live in one
(9, n_rays) table indexed by ray id, and the reverse of a bounce reads
each ray's id from the table that entered the bounce: the same sums, and
no permutation is recorded or applied.  The pixel cotangent is read by the
ray's pixel.

As in JAX, the recorded path is the forward kernel's (the render
dielectric), while the decisions and the adjoint follow pallas_grad's
``_decisions`` and ``_bounce_smooth`` (its cos_i dielectric).  The train
step's chunk seeds are JAX's own chain, ``sd * 1103515245 + 12345`` in
wrapping int32, not the forward's LCG modulo 2^31 - 1.  Not ported: the
Morton table order (``_morton_static``, ``_apply_perm_traced``) and the
windowed one-hot fetch and scatter, which the TPU needed and which leave
the gradients as they are; the TPU knobs of the forward; the sort knobs
(``sort_schedule``, ``cell_bits``, ``shrink_at``), which reorder rays only:
the steps run JAX's defaults; the sharded twin (waits for ``dist``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import _grad_math as gm
from .blockwise import _COLS, _bucket, _check_tables
from .blockwise_grad import _table_builder, bw_grad_supported
from .grad import _assemble_grads, _check
from .render import (_BIG, _MIN_HIT, WORD_MISS, WORD_PLANE, WORD_ROW, _chunk_seeds, _device,
                     _inv_size, _upload, hash_u01)
from .wavefront import (_ID_MASK, STATE_ROWS, _assemble, _forward_chunk, _schedule, wf_bounce)

__all__ = ["wf_grad_supported", "wf_rev", "wf_rev_plain", "make_wf_mse_step",
           "wf_mse_loss_and_grad", "make_wf_train_step"]

# rays per chunk of the gradient (pallas_wavefront_grad.py:985): a v5e
# memory figure kept as it is, because it fixes the chunking and so the
# chunk seeds
_GRAD_RAY_CAP = 1 << 23


def wf_grad_supported(scene) -> bool:
    """Whether the wavefront step takes this scene: the blockwise step's
    gate (at most 16384 spheres and planes, and no boxes)."""
    return bw_grad_supported(scene)


def _wf_grad_static(scene, size, spp: int, spp_chunk: int):
    """``(spp_chunk, s_pad, p_pad)`` (pallas_wavefront_grad.py:978-996)."""
    w, h = size
    n_pix = w * h
    spp_chunk = max(1, min(spp_chunk, spp))
    while n_pix * spp_chunk > _GRAD_RAY_CAP and spp_chunk > 1:
        spp_chunk -= 1
    if n_pix * spp_chunk > _ID_MASK:
        spp_chunk = max(1, _ID_MASK // n_pix)
    if n_pix > _ID_MASK:
        raise ValueError("frame too large for exact int32 ray ids")
    return spp_chunk, _bucket(scene.spheres.count), _bucket(scene.planes.count)


def _train_seeds(seed: int, n_chunks: int) -> np.ndarray:
    """The train step's chunk seeds (pallas_wavefront_grad.py:1220-1228):
    ``sd * 1103515245 + 12345`` in wrapping int32 from int32(seed)."""
    sd = (seed + 2**31) % 2**32 - 2**31
    out = []
    for _ in range(n_chunks):
        out.append(sd)
        sd = (sd * 1103515245 + 12345 + 2**31) % 2**32 - 2**31
    return np.asarray(out, np.int32)


def _recompute_t(pay, ispl, hit, o3, d3):
    """The winner's distance (``_BIG`` on a miss) and near-root bit from its
    payload, with the scan's own float ops (pallas_wavefront_grad
    ``_recompute_t``)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    bcx, bcy, bcz, brad, pnx, pny, pnz, pdd = pay[:8]
    ocx, ocy, ocz = ox - bcx, oy - bcy, oz - bcz
    bq = ocx * dx + ocy * dy + ocz * dz
    c0 = ocx * ocx + ocy * ocy + ocz * ocz - brad * brad
    disc = bq * bq - c0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -bq - sq
    root = t0 >= _MIN_HIT
    t_s = torch.where(root, t0, -bq + sq)
    nd = pnx * dx + pny * dy + pnz * dz
    t_p = -(pnx * ox + pny * oy + pnz * oz + pdd) / torch.where(nd.abs() > 1e-12, nd, 1.0)
    return torch.where(hit, torch.where(ispl, t_p, t_s), _BIG), root


def wf_rev_plain(spheres, planes, counts, cam, seeds, state, ids, words, limit, cot, cot_pix, *,
                 size, bounce, max_bounces, center_sample=False, rng_mode="reference",
                 with_l1=False):
    """Plain PyTorch version of the reverse kernel, on the device of ``cot``.

    Args:
      spheres, planes: padded (rows, 16) float32 tables; counts:
        (n_spheres, n_planes), their used rows.
      cam: (16,) float32 camera vector; seeds: (1,) int32, the chunk's seed.
      state, ids, limit: the (13, N) table and (N,) ids that entered bounce
        ``bounce`` and its limit (as :func:`.wavefront.wf_bounce` took
        them); None for bounce 0, whose rays 0..N-1 are regenerated
        (``center_sample``: sample 0 at the pixel centre).
      words: (N,) int32 winner words of the bounce.
      cot: (9, n_rays) float32 cotangents of every ray's outgoing origin,
        direction and throughput, by ray id; bounce b > 0 replaces a live
        ray's with those of its incoming values.
      cot_pix: (n_pix, 3) float32 pixel cotangent.

    Returns ``(sg, pg, cg)``, float64: the sphere gradient slots (9,
    n_spheres), the plane material slots (5, n_planes) and the camera
    cotangent (16,) (zero unless bounce 0).  ``with_l1=True`` returns
    ``(result, l1)``, ``l1`` holding per entry the sum of the magnitudes of
    its per-ray contributions.
    """
    w, h = size
    n_pix = w * h
    dev = cot.device
    f32, f64 = torch.float32, torch.float64
    ns, npl = counts
    sp, pl = spheres[:ns, :10], planes[:npl, :10]
    seed = int(seeds[0])
    rng_sphere = rng_mode == "sphere"
    per_sample = 2 + 4 * max_bounces
    n = words.shape[0]
    c = cam.tolist()
    inv_w, inv_h = _inv_size(w, h)
    if bounce == 0:
        ray = torch.arange(n, device=dev, dtype=torch.int64)
        pix, smp = ray % n_pix, ray // n_pix
        base = smp * per_sample
        jx, jy = hash_u01(pix, seed, base + 1), hash_u01(pix, seed, base + 2)
        if center_sample:
            jx, jy = torch.where(smp == 0, 0.5, jx), torch.where(smp == 0, 0.5, jy)
        px, py = (pix % w).to(f32), (pix // w).to(f32)
        o3, d3 = gm.raygen(c, px, py, jx, jy, inv_w, inv_h)
        one = torch.ones(n, dtype=f32, device=dev)
        thr3, lv = (one, one, one), one > 0.0
        ctr = base + 2
    else:
        ray = ids.to(torch.int64)
        pix, smp = ray % n_pix, ray // n_pix
        o3, d3, thr3 = (tuple(state[3 * g + i] for i in range(3)) for g in range(3))
        lv = state[12] > 0.0
        if limit is not None:
            lv = lv & (torch.arange(n, device=dev) < int(limit[0]))
        ctr = smp * per_sample + 2 + 4 * bounce
    rec = words.to(torch.int64)
    hit = (rec & WORD_MISS) == 0
    ispl = hit & ((rec & WORD_PLANE) != 0)
    row = torch.where(hit, rec & WORD_ROW, 0)
    pay, cls = gm.payload(sp, pl, hit, ispl, row)
    best_t, root = _recompute_t(pay, ispl, hit, o3, d3)
    u3 = gm.unit_draws(pix, seed, ctr + 1, rng_sphere)
    bits = gm.decisions(o3, d3, lv, best_t, pay, cls, ispl, root, u3, hash_u01(pix, seed, ctr + 4))
    cin = cot[:, ray]
    crad = tuple(cot_pix[pix, k] for k in range(3))
    co, cd, ct, slots = gm.bounce_adjoint(o3, d3, thr3, pay, u3, bits, tuple(cin[0:3]),
                                          tuple(cin[3:6]), tuple(cin[6:9]), crad)
    if bounce > 0:
        cot[:, ray[lv]] = torch.stack([*co, *cd, *ct])[:, lv]

    sg = torch.zeros((9, ns), dtype=f64, device=dev)
    pg = torch.zeros((5, npl), dtype=f64, device=dev)
    cg = torch.zeros(16, dtype=f64, device=dev)
    sg_l1, pg_l1, cg_l1 = sg.clone(), pg.clone(), cg.clone()
    live_h = bits["live_h"]
    vals = torch.stack(slots).to(f64)
    for acc, acc_l1, m, v in ((sg, sg_l1, live_h & ~ispl, vals), (pg, pg_l1, live_h & ispl,
                                                                  vals[4:])):
        acc.index_add_(1, row[m], v[:, m])
        acc_l1.index_add_(1, row[m], v[:, m].abs())
    if bounce == 0:
        cam_cot = torch.stack(gm.raygen_adjoint(c, px, py, jx, jy, inv_w, inv_h, co, cd)).to(f64)
        cg[:15] = cam_cot.sum(dim=1)
        cg_l1[:15] = cam_cot.abs().sum(dim=1)
    return ((sg, pg, cg), (sg_l1, pg_l1, cg_l1)) if with_l1 else (sg, pg, cg)


@functools.cache
def _kernel():
    from ._build import load_library

    fn = load_library("wf_grad_kernel").rt_wf_rev
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, f, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def wf_rev(spheres, planes, counts, cam, seeds, state, ids, words, limit, cot, cot_pix, *, size,
           bounce, max_bounces, center_sample=False, rng_mode="reference", out=None):
    """One launch of the reverse kernel; arguments and result as
    :func:`wf_rev_plain`.  With ``out=(sg, pg, cg)`` (float64) the
    gradients are added to those tensors, which are returned.  CPU tensors
    run the plain version; CUDA tensors launch the kernel on the current
    stream (without synchronizing) or raise."""
    fn = "wf_rev"
    dev = cot.device
    given = (("spheres", spheres), ("planes", planes), ("cam", cam), ("seeds", seeds),
             ("words", words), ("cot_pix", cot_pix))
    if bounce > 0:
        given += (("state", state), ("ids", ids)) + ((("limit", limit),) if limit is not None
                                                      else ())
    for name, t in given:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device} but cot on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    w, h = size
    n, n_rays = words.shape[0], cot.shape[1]
    if not 0 <= bounce < max_bounces:
        raise ValueError(f"{fn}: bounce {bounce} outside 0..{max_bounces - 1}")
    if w < 1 or h < 1 or w * h * 3 >= 2**31 or not 1 <= n <= n_rays < 2**31:
        raise ValueError(f"{fn}: bad size {w}x{h}, {n} rays or a cotangent table of {n_rays}")
    ns, npl = counts
    shapes = ((9, ns), (5, npl), (16,))
    if out is not None:
        for name, t, shape in zip(("sg", "pg", "cg"), out, shapes):
            _check(fn, name, t, torch.float64, shape, dev)
    if dev.type == "cpu":
        got = wf_rev_plain(spheres, planes, counts, cam, seeds, state, ids, words, limit, cot,
                           cot_pix, size=size, bounce=bounce, max_bounces=max_bounces,
                           center_sample=center_sample, rng_mode=rng_mode)
        if out is None:
            return got
        for o, g in zip(out, got):
            o += g
        return out
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    _check_tables(fn, (spheres, planes), counts, dev)
    _check(fn, "cam", cam, torch.float32, (16,), dev)
    _check(fn, "seeds", seeds, torch.int32, (1,), dev)
    _check(fn, "words", words, torch.int32, (n,), dev)
    _check(fn, "cot", cot, torch.float32, (9, n_rays), dev)
    _check(fn, "cot_pix", cot_pix, torch.float32, (w * h, 3), dev)
    if bounce > 0:
        _check(fn, "state", state, torch.float32, (STATE_ROWS, n), dev)
        _check(fn, "ids", ids, torch.int32, (n,), dev)
        if limit is not None:
            _check(fn, "limit", limit, torch.int32, (1,), dev)
    if out is None:
        out = tuple(torch.zeros(s, dtype=torch.float64, device=dev) for s in shapes)
    sg, pg, cg = out
    inv_w, inv_h = _inv_size(w, h)
    ptr = lambda t: t.data_ptr() if t is not None and bounce > 0 else None  # noqa: E731
    with torch.cuda.device(dev):
        err = _kernel()(
            spheres.data_ptr(), ns, planes.data_ptr(), npl, cam.data_ptr(), seeds.data_ptr(),
            ptr(state), ptr(ids), words.data_ptr(), ptr(limit), cot.data_ptr(),
            cot_pix.data_ptr(), sg.data_ptr(), pg.data_ptr(), cg.data_ptr(), n, n_rays, w * h, w,
            inv_w, inv_h, bounce, max_bounces, int(bool(center_sample)),
            int(rng_mode == "sphere"), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wavefront reverse kernel launch failed: CUDA error {err}")
    wf_rev.launches += 1
    return out


wf_rev.launches = 0


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _wf_pipeline(scene, target, size, *, spp, spp_chunk, max_bounces, rng_mode, dev):
    """``_wf_grad_pipeline``'s body: ``(run, n_chunks)``, ``run(s_tab, p_tab,
    cam, seeds, center_first) -> (loss, grads)`` for tables of ``scene``'s
    shape, ``seeds`` the (n_chunks, 1) int32 chunk seeds on the device."""
    w, h = size
    n_pix = w * h
    chunk, _, _ = _wf_grad_static(scene, size, spp, spp_chunk)
    ks = [min(chunk, spp - s) for s in range(0, spp, chunk)]
    sched, shrink_at = _schedule(max_bounces, None, -1)  # JAX's defaults: sorts (1, 2, 5)
    counts = (scene.spheres.count, scene.planes.count)
    s_mat = scene.spheres.material[:counts[0]].to(device=dev, dtype=torch.int64)
    p_mat = scene.planes.material[:counts[1]].to(device=dev, dtype=torch.int64)
    tables = (scene.spheres.center.shape[0], scene.materials.albedo.shape[0])
    tgt = torch.as_tensor(target, dtype=torch.float32).reshape(h, w, 3).to(dev).contiguous()
    no_boxes = torch.zeros((0, _COLS), dtype=torch.float32, device=dev)
    kw = dict(size=size, max_bounces=max_bounces, rng_mode=rng_mode)

    def run(s_tab, p_tab, cam, seeds, center_first):
        # ---- record forward: the frame, and per chunk the saved bounces ----
        total, chunks = None, []
        for ci, k in enumerate(ks):
            center = ci == 0 and center_first

            def bounce(b, state, ids, limit, seed=seeds[ci], center=center):
                return wf_bounce(s_tab, p_tab, no_boxes, (*counts, 0), cam, seed, state, ids,
                                 limit, bounce=b, center_sample=center, record=True, **kw)

            state, ids, saved = _forward_chunk(bounce, n_pix * k, dev, max_bounces=max_bounces,
                                               sched=sched, shrink_at=shrink_at,
                                               cell_bits=2, record=True)
            img = _assemble(state, ids, n_pix, k)
            total = img if total is None else total + img
            chunks.append((k, center, saved))
        # ---- loss and pixel cotangent (pre-gamma), as the blockwise step ----
        diff = total.reshape(h, w, 3) * float(np.float32(1.0 / spp)) - tgt
        loss = torch.mean(diff ** 2)
        cot_pix = (2.0 * diff / (3.0 * n_pix * spp)).reshape(n_pix, 3)
        # ---- reverse: bounce B-1 down to 0, cotangents by ray id ----
        acc = tuple(torch.zeros(s, dtype=torch.float64, device=dev)
                    for s in ((9, counts[0]), (5, counts[1]), (16,)))
        for ci, (k, center, saved) in enumerate(chunks):
            cot = torch.zeros((9, n_pix * k), dtype=torch.float32, device=dev)
            for b in reversed(range(max_bounces)):
                state, ids, words, limit = saved[b]
                wf_rev(s_tab, p_tab, counts, cam, seeds[ci], state, ids, words, limit, cot,
                       cot_pix, bounce=b, center_sample=center, out=acc, **kw)
        return loss, _assemble_grads(*(a.float() for a in acc), s_mat, p_mat, *tables)

    return run, len(ks)


def make_wf_mse_step(
    params,
    scene,
    target,
    size: tuple[int, int],
    *,
    spp: int = 4,
    max_bounces: Optional[int] = None,
    personality: str = "mg",
    rng_mode: str = "reference",
    spp_chunk: int = 4,
    center_sample: Optional[bool] = None,
    device="cuda",
):
    """Prebuilt wavefront fwd+bwd step at fixed ``params``: ``step(seed) ->
    (loss, grads)``.

    ``params`` (a dict of tensors keyed like
    :func:`rt_tpu_torch.diff.extract_params`, or a subset) go to ``device``
    and the tables and camera are built there from them once; ``target``
    ((H, W, 3) pre-gamma radiance) goes to ``device`` once, and each call
    ships the chunk seeds (the forward's LCG chain).  The frame inside the
    step is ``render_forward_wavefront(..., gamma=False)``'s at the same
    seed; the loss is its MSE against the target, and ``grads`` holds the
    detached-sampling gradients of the scene's seven differentiable keys.
    """
    dev = _device(device)
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    tables = _table_builder(scene, personality, size, dev)(
        {k: torch.as_tensor(v).to(dev) for k, v in params.items()})
    run, n_chunks = _wf_pipeline(scene, target, size, spp=spp, spp_chunk=spp_chunk,
                                 max_bounces=max_bounces, rng_mode=rng_mode, dev=dev)
    center_first = True if center_sample is None else center_sample

    def step(seed: int = 0):
        seeds = _upload(_chunk_seeds(seed, n_chunks), dev)
        return run(*tables, seeds, center_first)

    return step


def wf_mse_loss_and_grad(params, scene, target, size, seed: int = 0, **kw):
    """``(loss, grads)`` of one wavefront fused step (:func:`make_wf_mse_step`'s
    arguments)."""
    return make_wf_mse_step(params, scene, target, size, **kw)(seed)


def make_wf_train_step(
    optimizer: torch.optim.Optimizer,
    scene,
    target,
    size: tuple[int, int],
    *,
    spp: int = 4,
    max_bounces: Optional[int] = None,
    personality: str = "mg",
    rng_mode: str = "reference",
    spp_chunk: int = 4,
    device="cuda",
):
    """One optimizer step per call on the wavefront pipeline: ``step(params,
    seed) -> loss``, as :func:`rt_tpu_torch.ops.blockwise_grad.make_bw_train_step`:
    the tables rebuilt on the device from ``params``, the fused step,
    ``.grad`` set for every tensor of ``params``, ``optimizer.step()``.
    Nothing but the chunk seeds (JAX's wrapping int32 chain of ``seed``)
    goes to the device per call.  ``target`` must be PRE-gamma radiance."""
    dev = _device(device)
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    build = _table_builder(scene, personality, size, dev)
    run, n_chunks = _wf_pipeline(scene, target, size, spp=spp, spp_chunk=spp_chunk,
                                 max_bounces=max_bounces, rng_mode=rng_mode, dev=dev)

    def step(params, seed: int):
        seeds = _upload(_train_seeds(seed, n_chunks).reshape(-1, 1), dev)
        loss, grads = run(*build(params), seeds, True)
        for k, p in params.items():
            p.grad = grads[k]
        optimizer.step()
        return loss

    return step
