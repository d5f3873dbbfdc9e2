"""Bounce-major (wavefront) forward render for scenes of up to 16384
primitives (port of ``rt_tpu.ops.pallas_wavefront``'s
``render_forward_wavefront``).

Ray state lives in device memory as a table, and one launch of the kernel
(``csrc/wavefront_kernel.cu``) advances every ray of it by one bounce.
Between bounces the table is sorted: dead rays to the back (compaction)
and live rays by direction octant and a coarse origin cell (coherence).
After the sort at ``shrink_at`` the kernel reads the live-prefix length
from device memory and its threads past it return at once: the TPU's
bucketed live-prefix shrink, without a host sync per bounce.  The draws
are the counter hash keyed by (pixel, sample, bounce), so a ray traces the
same path wherever the sorts put it, and the frame equals the blockwise
kernel's (``rng_impl="hash"``) at the same seed: the kernel runs the
blockwise kernel's per-ray bounce (``csrc/trace.cuh``).

* :func:`wf_bounce_plain` — the kernel's function in plain PyTorch, dense
  over the rays of the table (one table row at a time, as
  :func:`rt_tpu_torch.ops.render.render_tile_plain`).  It is the CPU path
  and the reference the kernel is compared with on the card.
* :func:`wf_bounce` — the kernel wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor to the kernel, and nothing else.
  ``wf_bounce.launches`` counts kernel launches.  After bounce 0 the
  kernel splits each live ray's scan over a group of lanes, as many as the
  live count (which the wrapper counts on the card) leaves room for (the
  kernel's source note); the split changes the order of the work, never
  the winner.
* :func:`render_forward_wavefront` — the entry point: per sample chunk the
  bounce-0 launch (raygen + bounce 0), the sorts of the schedule and one
  launch per later bounce, then the frame assembled by ray id.

State: a (13, N) float32 table — origin 0-2, direction 3-5, throughput
6-8, radiance 9-11, live 12 — and an int32 (N,) vector of ray ids (sample
* n_pix + pixel, chunk-local); with ``record=True`` the launch also
returns the rays' winner words (row | plane bit 24 | box bit 26, or bit 25
alone on a miss: ``render.WORD_*``).  The JAX package bitcast the ids into
a float state row with a bit-30 tag against the TPU's subnormal flush;
int32 ids need neither.  The sorts are ``torch.sort(stable=True)`` and a
gather, as the JAX package's are XLA sorts and not Pallas.

Not ported (TPU tuning knobs, each leaving the frame as it is; passing one
is a ``TypeError``): ``block``, ``cull``, ``cull_group``, ``cull_gen``,
``order`` (Morton), ``sort_mode``, ``pipeline``, ``wf_rows``,
``extract_window``, ``dbg``, ``interpret``.  ``rng_impl`` other than
"hash" is a ``ValueError``, as in JAX.
:func:`render_forward_wavefront_sharded` is the sharded twin: each rank
of a mesh axis runs the wavefront over its range of every chunk's rays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..profiling import count_live, recording, span
from . import _grad_math as gm
from .blockwise import _check_tables, _device_tables, blockwise_supported
from .grad import _check
from .render import (WORD_MISS, _bounce_plain, _chunked_frame, _device, _inv_size, _pack_camera,
                     _upload, hash_u01)

__all__ = ["STATE_ROWS", "wavefront_supported", "wf_bounce", "wf_bounce_plain",
           "render_forward_wavefront", "render_forward_wavefront_sharded"]

STATE_ROWS = 13
# Chunk caps of the JAX package, kept as they are: ray ids stay exact below
# 2^30 (the JAX tag bit), and 2^25 rays per chunk is a v5e memory figure.
# They fix the chunking, and the chunking fixes each chunk's seed and so
# the draws: other caps would render another (equally valid) frame than
# JAX's.
_ID_MASK = (1 << 30) - 1
_HBM_RAY_CAP = 1 << 25


def wavefront_supported(scene, include_boxes: bool = False) -> bool:
    """The blockwise kernel's envelope (the bounce is the same)."""
    return blockwise_supported(scene, include_boxes)


def _resolve_chunk(size, spp: int, spp_chunk: int) -> int:
    """Samples per chunk (pallas_wavefront.py:738-752)."""
    w, h = size
    spp_chunk = max(1, min(spp_chunk, spp))
    if w * h * spp_chunk > _ID_MASK:
        spp_chunk = max(1, _ID_MASK // (w * h))
    if w * h * spp_chunk > _HBM_RAY_CAP:
        spp_chunk = max(1, _HBM_RAY_CAP // (w * h))
    if w * h > _ID_MASK:
        raise ValueError("frame too large for exact int32 ray ids")
    return spp_chunk


def _schedule(max_bounces: int, sort_schedule, shrink_at):
    """The sort schedule and the shrink bounce (pallas_wavefront.py:775-791):
    sorts before bounces 1, 2 and 5, the live prefix from the sort at 2."""
    if sort_schedule is None:
        sort_schedule = tuple(b for b in (1, 2, 5) if b < max_bounces)
    if shrink_at == -1:
        cands = [b for b in sort_schedule if b >= 2]
        shrink_at = cands[0] if cands else None
    if shrink_at is not None and shrink_at not in sort_schedule:
        raise ValueError("shrink_at must name a bounce in sort_schedule")
    return tuple(sort_schedule), shrink_at


def _sort_key(state: torch.Tensor, cell_bits: int) -> torch.Tensor:
    """int32 sort key per ray (pallas_wavefront._sort_key, bit for bit):
    dead rays last, then direction octant, then a coarse origin cell on
    bounds taken from the live origins."""
    i32 = torch.int32
    live = state[12] > 0.0
    octant = ((state[3] > 0).to(i32) * 4 + (state[4] > 0).to(i32) * 2 + (state[5] > 0).to(i32))
    nc = 1 << cell_bits
    cell = torch.zeros_like(octant)
    for a in range(3):
        o = state[a]
        lo = o.masked_fill(~live, 3e38).min()
        hi = o.masked_fill(~live, -3e38).max()
        span = torch.clamp_min(hi - lo, 1e-6)
        q = torch.clamp((o - lo) / span * nc, 0, nc - 1).to(i32)
        cell = (cell << cell_bits) | q
    key = (octant << (3 * cell_bits)) | cell
    return key.masked_fill(~live, 1 << (3 + 3 * cell_bits))


def _sort_state(state, ids, cell_bits: int):
    """Compaction and coherence sort: ``(state, ids, n_live)`` with the
    columns in stable key order and n_live, the live count, as a (1,)
    int32 tensor on the device (no host sync)."""
    with span("rt.sort"):
        key = _sort_key(state, cell_bits)
        perm = torch.sort(key, stable=True).indices
        state = state.index_select(1, perm)
        n_live = (state[12] > 0.0).sum(dtype=torch.int32).reshape(1)
        return state, ids.index_select(0, perm), n_live


def wf_bounce_plain(spheres, planes, boxes, counts, cam, seeds, state, ids, limit=None, *, size,
                    bounce, max_bounces, center_sample=False, rng_mode="reference",
                    record=False, rays=None, ray0=0, total=None):
    """Plain PyTorch version of the kernel, on the device of ``state``.

    Args:
      spheres, planes, boxes: padded (rows, 16) float32 tables
        (``blockwise._padded_table``); counts: (n_spheres, n_planes,
        n_boxes), their used rows (n_boxes = 0 leaves boxes untested).
      cam: (16,) float32 camera vector; seeds: (1,) int32, the chunk's seed.
      state: (13, N) float32, ids: (N,) int32, updated in place.
      limit: None, or a (1,) int32 live-prefix length: rays at and past it
        are left as they are (they are dead).
      bounce: 0 (the TPU kernel's gen mode: raygen + bounce 0 of the rays
        with ids 0..N-1; ``state`` and ``ids`` are written from nothing,
        ``center_sample`` puts sample 0 at the pixel centre) or b > 0 (one
        bounce of every live ray; a dead ray is left as it is).
      rays: bounce 0 only, the (N,) ray ids the columns generate in place of
        0..N-1: some columns of a wider launch, without the rest.
      ray0, total: bounce 0 only, a shard of a chunk of ``total`` rays:
        the columns generate the rays ``ray0 .. ray0 + N - 1`` (``rays``
        plus ``ray0``, if given), and a column whose id is at or past
        ``total`` (a shard's padding) is a dead ray of zeros.

    Returns the rays' winner words, (N,) int32, with ``record`` (a ray
    that was not live: the miss word), else None.
    """
    w, h = size
    n_pix = w * h
    n = state.shape[1]
    dev = state.device
    ns, npl, nb = counts
    rows = (planes[:npl, :10].tolist(), spheres[:ns, :10].tolist(), boxes[:nb, :12].tolist())
    seed = int(seeds[0])
    per_sample = 2 + 4 * max_bounces
    if rays is not None:
        if bounce != 0 or rays.shape != (n,):
            raise ValueError("rays: the (N,) ids of a bounce-0 launch's columns")
        ray = rays.to(device=dev, dtype=torch.int64) + ray0
    elif bounce == 0:
        ray = torch.arange(ray0, ray0 + n, device=dev, dtype=torch.int64)
    else:
        ray = ids.to(torch.int64)
    pix, smp = ray % n_pix, ray // n_pix
    if bounce == 0:
        base = smp * per_sample
        jx, jy = hash_u01(pix, seed, base + 1), hash_u01(pix, seed, base + 2)
        if center_sample:
            jx, jy = torch.where(smp == 0, 0.5, jx), torch.where(smp == 0, 0.5, jy)
        inv_w, inv_h = _inv_size(w, h)
        o3, d3 = gm.raygen(cam.tolist(), (pix % w).to(torch.float32),
                           (pix // w).to(torch.float32), jx, jy, inv_w, inv_h)
        one = torch.ones(n, dtype=torch.float32, device=dev)
        thr3, rad0, live = (one, one, one), (one * 0.0,) * 3, one
        ctr = base + 2
    else:
        o3, d3, thr3, rad0 = (tuple(state[3 * g + i] for i in range(3)) for g in range(4))
        live = state[12]
        if limit is not None:
            live = torch.where(torch.arange(n, device=dev) < int(limit[0]), live, 0.0)
        ctr = smp * per_sample + 2 + 4 * bounce
    u3 = tuple(hash_u01(pix, seed, ctr + i) for i in (1, 2, 3))
    rad, o_n, d_n, thr_n, af, word = _bounce_plain(rows, o3, d3, thr3, live, u3,
                                                   hash_u01(pix, seed, ctr + 4),
                                                   rng_mode == "sphere", record)
    new = torch.stack([*o_n, *d_n, *thr_n, *(r0 + r for r0, r in zip(rad0, rad)), af])
    if bounce == 0:
        alive = n
        if total is not None:
            alive = inside = ray < total
            new = torch.where(inside, new, 0.0)
            word = torch.where(inside, word, WORD_MISS) if record else None
        state.copy_(new)
        ids.copy_(ray)
    else:
        alive = live > 0.0
        state.copy_(torch.where(alive, new, state))
    if recording():
        count_live(bounce, alive)
    return word.to(torch.int32) if record else None


def _library():
    from ._build import load_library

    return load_library("wavefront_kernel")


@functools.cache
def _kernel():
    fn = _library().rt_wf_bounce
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, p, p, p, p, p, p, p, i, i, i, i, i, f, f, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _split_lanes(live: int) -> int:
    """The lanes per ray (G) that a later bounce's launch gives ``live``
    live rays on this process's card (``rt_wf_split_lanes``: the smallest
    power of two up to 32 with live x G at least the kernel's resident
    threads).  Card only; the tests and chip_smoke.py choose their inputs
    with it."""
    fn = _library().rt_wf_split_lanes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(live)


def wf_bounce(spheres, planes, boxes, counts, cam, seeds, state, ids, limit=None, *, size,
              bounce, max_bounces, center_sample=False, rng_mode="reference", record=False,
              ray0=0, total=None):
    """One launch of the wavefront kernel; arguments and result as
    :func:`wf_bounce_plain` (``ray0``/``total``: a bounce-0 launch's shard
    of a chunk).  CPU tensors run the plain version; CUDA tensors launch
    the kernel on the current stream (without synchronizing) or raise."""
    fn = "wf_bounce"
    dev = state.device
    for name, t in (("spheres", spheres), ("planes", planes), ("boxes", boxes), ("cam", cam),
                    ("seeds", seeds), ("ids", ids)) + ((("limit", limit),) if limit is not None
                                                       else ()):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device} but state on {dev}")
    if rng_mode not in ("reference", "sphere"):
        raise ValueError(f"unknown rng_mode {rng_mode!r}")
    w, h = size
    n = state.shape[1]
    if not 0 <= bounce < max_bounces:
        raise ValueError(f"{fn}: bounce {bounce} outside 0..{max_bounces - 1}")
    if w < 1 or h < 1 or w * h * 3 >= 2**31 or not 1 <= n < 2**31:
        raise ValueError(f"{fn}: bad size {w}x{h} or {n} rays")
    total = n if total is None else total
    if ray0 < 0 or ray0 + n >= 2**31 or not 1 <= total <= _ID_MASK + 1:
        raise ValueError(f"{fn}: bad rays {ray0}..{ray0 + n - 1} of {total}")
    if dev.type == "cpu":
        return wf_bounce_plain(spheres, planes, boxes, counts, cam, seeds, state, ids, limit,
                               size=size, bounce=bounce, max_bounces=max_bounces,
                               center_sample=center_sample, rng_mode=rng_mode, record=record,
                               ray0=ray0, total=total)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    _check_tables(fn, (spheres, planes, boxes), counts, dev)
    _check(fn, "cam", cam, torch.float32, (16,), dev)
    _check(fn, "seeds", seeds, torch.int32, (1,), dev)
    _check(fn, "state", state, torch.float32, (STATE_ROWS, n), dev)
    _check(fn, "ids", ids, torch.int32, (n,), dev)
    if limit is not None:
        _check(fn, "limit", limit, torch.int32, (1,), dev)
    words = torch.empty(n, dtype=torch.int32, device=dev) if record else None
    # a later bounce splits each live ray's scan over as many lanes as the
    # live count leaves room for: counted here, on the card
    live = (state[12] > 0.0).sum(dtype=torch.int32).reshape(1) if bounce else None
    inv_w, inv_h = _inv_size(w, h)
    with torch.cuda.device(dev):
        err = _kernel()(
            spheres.data_ptr(), counts[0], planes.data_ptr(), counts[1], boxes.data_ptr(),
            counts[2], cam.data_ptr(), seeds.data_ptr(), state.data_ptr(), ids.data_ptr(),
            words.data_ptr() if record else None, limit.data_ptr() if limit is not None else None,
            live.data_ptr() if bounce else None, n, ray0, total, w * h, w, inv_w, inv_h, bounce,
            max_bounces,
            int(bool(center_sample)),
            int(rng_mode == "sphere"), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error {err}")
    wf_bounce.launches += 1
    if recording():
        # the rays a bounce-0 launch generates (those of its columns inside
        # the chunk), or the live count the launch already read
        count_live(bounce, live if bounce else max(0, min(n, total - ray0)))
    return words


wf_bounce.launches = 0


def _forward_chunk(launch, n_rays: int, dev, *, max_bounces: int, sched, shrink_at, cell_bits,
                   record: bool = False):
    """The bounces of one sample chunk of ``n_rays`` rays:
    ``launch(bounce, state, ids, limit) -> words`` runs one (see
    :func:`wf_bounce`), with the compaction sorts of ``sched`` before their
    bounces and, from the sort at ``shrink_at`` on, the live count as the
    launches' limit.  Returns ``(state, ids, saved)``: the final table and,
    with ``record``, per bounce b the (state, ids, words, limit) the
    reverse needs — the table as it entered the bounce (None for b = 0,
    whose rays the reverse regenerates), its winner words and limit."""
    state = torch.empty((STATE_ROWS, n_rays), dtype=torch.float32, device=dev)
    ids = torch.empty(n_rays, dtype=torch.int32, device=dev)
    with span("rt.bounce", 0):
        words = launch(0, state, ids, None)
    saved = [(None, None, words, None)] if record else None
    limit = None
    for b in range(1, max_bounces):
        if b in sched:
            state, ids, n_live = _sort_state(state, ids, cell_bits)
            if shrink_at is not None and b >= shrink_at:
                limit = n_live
        if record:
            entering, state = state, state.clone()
            with span("rt.bounce", b):
                words = launch(b, state, ids, limit)
            saved.append((entering, ids, words, limit))
        else:
            with span("rt.bounce", b):
                launch(b, state, ids, limit)
    return state, ids, saved


def _radiance_by_id(state, ids, ray0: int = 0) -> torch.Tensor:
    """The table's per-ray radiance back in ray-id order: (3, N), column j
    the ray of id ``ray0 + j``."""
    rad = torch.empty((3, state.shape[1]), dtype=torch.float32, device=state.device)
    rad.index_copy_(1, ids.to(torch.int64) - ray0, state[9:12])
    return rad


def _sum_samples(rad, n_pix: int, k: int) -> torch.Tensor:
    """(n_pix, 3) contiguous sums over the k samples of a chunk's (3, >=
    n_pix * k) radiance by ray id, in sample order (the JAX addition order,
    so the frame equals the blockwise kernel's)."""
    acc = rad[:, :n_pix]
    for s in range(1, k):
        acc = acc + rad[:, s * n_pix:(s + 1) * n_pix]
    return acc.T.contiguous()


def _assemble(state, ids, n_pix: int, k: int):
    """The chunk's (n_pix, 3) radiance sums from its final table."""
    return _sum_samples(_radiance_by_id(state, ids), n_pix, k)


def render_forward_wavefront(
    scene,
    size: tuple[int, int],
    seed: int = 0,
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    spp_chunk: int = 4,
    gamma: bool = True,
    rng_mode: str = "reference",
    rng_impl: str = "hash",
    center_sample: Optional[bool] = None,
    sort_schedule: Optional[tuple] = None,
    cell_bits: int = 2,
    shrink_at: Optional[int] = -1,
    include_boxes: bool = False,
    device="cuda",
    mesh=None,
    axis: str = "rays",
) -> torch.Tensor:
    """Render a full frame with the wavefront pipeline.  Returns (H, W, 3)
    float32 on ``device``.

    The frame equals ``render_forward_blockwise`` at the same seed; the
    schedule knobs (``sort_schedule``, ``cell_bits``, ``shrink_at``) change
    the order rays run in, never the frame.  ``spp_chunk`` samples share a
    chunk (and its seed), capped as in JAX.  With ``device="cpu"`` the
    plain PyTorch version renders.  With ``mesh`` (a
    :func:`rt_tpu_torch.dist.make_mesh` mesh) the rays are sharded over
    ``mesh[axis]``: :func:`render_forward_wavefront_sharded`.
    """
    from ..dist import mesh_axis, shard_range

    if rng_impl != "hash":
        raise ValueError("wavefront kernel is hash-RNG only (reordering would change the "
                         "hw-PRNG stream); pass rng_impl='hash'")
    if not wavefront_supported(scene, include_boxes):
        raise ValueError("scene exceeds the wavefront kernel limits")
    dev = _device(device)
    w, h = size
    n_pix = w * h
    spp = scene.samples_per_pixel if spp is None else spp
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    chunk = _resolve_chunk(size, spp, spp_chunk)
    sched, shrink_at = _schedule(max_bounces, sort_schedule, shrink_at)
    center_first = True if center_sample is None else center_sample
    ax = None if mesh is None else mesh_axis(mesh, axis)
    spheres, planes, boxes, counts = _device_tables(scene, personality, include_boxes, dev)

    def launch(cam, seeds, k, first):
        total = n_pix * k
        ray0, rays = (0, total) if ax is None else shard_range(total, ax, 512)

        def bounce(b, state, ids, limit):
            return wf_bounce(spheres, planes, boxes, counts, cam, seeds, state, ids, limit,
                             size=size, bounce=b, max_bounces=max_bounces,
                             center_sample=first and center_first, rng_mode=rng_mode,
                             ray0=ray0, total=total)

        state, ids, _ = _forward_chunk(bounce, rays, dev, max_bounces=max_bounces,
                                       sched=sched, shrink_at=shrink_at, cell_bits=cell_bits)
        with span("rt.assemble"):
            rad = _radiance_by_id(state, ids, ray0)
            if ax is not None:
                rad = ax.all_gather(rad.T).T
            return _sum_samples(rad, n_pix, k).reshape(h, w, 3)

    cam = _upload(_pack_camera(scene.camera, size), dev)
    return _chunked_frame(launch, cam, seed, spp, 1, gamma, dev, chunk=chunk)


def render_forward_wavefront_sharded(scene, size: tuple[int, int], mesh, seed: int = 0, *,
                                     axis: str = "rays", **opts) -> torch.Tensor:
    """:func:`render_forward_wavefront` (its ``opts``) sharded over
    ``mesh[axis]`` (a :func:`rt_tpu_torch.dist.make_mesh` mesh): the whole
    (H, W, 3) frame on every rank, equal bit for bit to the unsharded frame.

    Each rank owns a contiguous global ray range of every sample chunk
    (JAX's 512-ray spans; the last shard padded with dead rays) and runs
    its own wavefront over it: its bounce-0 launch takes the range's first
    ray id and the chunk's ray count, so ray ids and draws stay global (the
    TPU kernel's ray_offset), and its compaction sorts and live-prefix
    shrink are its own.  The chunk's per-ray radiance is gathered over
    ``axis`` by ray id and summed over its samples in sample order.  The
    chunk cap is the unsharded route's, against the global ray count (as
    JAX's): the chunking fixes the chunk seeds, so a cap per rank would
    render another frame wherever it binds."""
    return render_forward_wavefront(scene, size, seed, mesh=mesh, axis=axis, **opts)
