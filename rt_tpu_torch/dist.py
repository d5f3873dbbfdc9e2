"""Sharding over ranks: the ('rays', 'prims') mesh on ``torch.distributed``
(port of ``rt_tpu.dist``).

The JAX package runs one controller over every device of a
``jax.sharding.Mesh`` (``shard_map``).  Here, in PyTorch's own idiom, each
rank is a process: :func:`initialize` joins the process group, and
:func:`make_mesh` lays the ranks out as a ``DeviceMesh`` of shape
``(n_rays, n_prims)`` with ``mesh_dim_names=("rays", "prims")``, whose
axes' process groups carry the collectives.

* **'rays'** — data parallelism over pixels and rays: each rank renders a
  contiguous slice of the padded pixel (or ray) range.  The draws are keyed
  by the *global* chunk, pixel or ray index, so a sharded frame is the
  unsharded frame bit for bit, whatever the mesh.
* **'prims'** (optional) — the sphere table is sharded: each rank
  intersects its slice, and the per-shard winners are combined by an
  ``all_gather`` over the axis and an argmin that keeps the first (lowest
  shard, so lowest global index) of equal distances.
* Gradients.  JAX's ``shard_map`` transposes the collectives; here each
  collective that carries a gradient is an autograd Function whose
  backward is that transpose.  Every rank computes the same loss from the
  gathered frame, and ranks along 'prims' trace the same rays, so a
  rank's cotangents are *partial*: the true cotangent of a tensor that a
  group of ranks all hold is the sum of theirs.  :func:`gather_rays`
  hands each rank the cotangent of its own slice divided by the 'prims'
  size (no collective), which starts that rule; the 'prims' gathers and
  sums transpose as a sum over 'prims' (:class:`MeshAxis`); and
  :func:`replicate` (identity forward) sums every scene parameter's
  partial gradients over the world once, at the end of the backward.
  Each ray's contribution so counts once.  The ranks of an axis build the
  same autograd graph, so they reach its collectives in the same order,
  the recomputation of a checkpointed chunk (``remat``) included.

Backend and device (:func:`initialize`): NCCL where every rank has a card
of its own, Gloo on the CPU and where ranks share a card (NCCL refuses two
ranks on one GPU).  Gloo takes the card's tensors for every collective
the routes run (all_gather and all_reduce; checked on the H100 machine,
chip_smoke.py phase 8), so no collective is staged through host memory
here.  :func:`run_local` starts ``n`` local ranks in
processes of their own (the ``spawn`` start method) for one command:
the CLI's ``--mesh``, ``python -m rt_tpu_torch.mp_check`` and the tests
use it; ``torchrun`` starts them instead where it is at hand.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as _queue
import socket
import time
import traceback
from typing import NamedTuple, Optional

import torch
import torch.distributed as tdist

__all__ = ["MeshAxis", "initialize", "make_mesh", "mesh_axis", "shard_spheres",
           "sharded_hit_fn", "render_image_sharded", "gather_rays", "replicate", "shard_range",
           "run_local"]

AXES = ("rays", "prims")
_TIMEOUT = 60.0


# ---------------------------------------------------------------------------
# the world and the mesh
# ---------------------------------------------------------------------------


def initialize(*, device="cuda", timeout: float = _TIMEOUT, **kwargs) -> Optional[torch.device]:
    """Join the process group (``torch.distributed.init_process_group``):
    this rank's device, or None when there is nothing to join.

    ``kwargs`` go to ``init_process_group`` (``init_method``, default
    ``env://``, so ``torchrun`` works; ``world_size``; ``rank``), with
    ``local_rank`` (default ``LOCAL_RANK``, else the rank) picking the card.
    A no-op in a process that no launcher started (no ``WORLD_SIZE``)
    and without kwargs, as JAX's is; also when the world is already
    joined.  The backend is decided here, before any mesh
    is built: NCCL when ``device`` is a card and every rank has one
    (``world_size <= torch.cuda.device_count()``; the rank's device is
    ``cuda:local_rank``), else Gloo (the CPU, or ranks sharing the cards:
    rank r on ``cuda:(local_rank % cards)``).  ``timeout`` (seconds) bounds
    every collective, so a lost rank fails the others instead of hanging
    them."""
    if tdist.is_initialized():
        return _rank_device(device)
    if not kwargs and "WORLD_SIZE" not in os.environ:
        return None
    from .ops.tables import _device

    dev = _device(device)
    world = int(kwargs.get("world_size", os.environ.get("WORLD_SIZE", 1)))
    rank = int(kwargs.get("rank", os.environ.get("RANK", 0)))
    local = int(kwargs.pop("local_rank", os.environ.get("LOCAL_RANK", rank)))
    backend = kwargs.pop("backend", None)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend is None:
            backend = "nccl" if world <= cards else "gloo"
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    elif backend is None:
        backend = "gloo"
    kwargs.setdefault("init_method", "env://")
    kwargs.setdefault("world_size", world)
    kwargs.setdefault("rank", rank)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout), **kwargs)
    if backend == "nccl":
        kw["device_id"] = dev
    tdist.init_process_group(**kw)
    return dev


def _rank_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_rays: Optional[int] = None, n_prims: int = 1):
    """The ('rays', 'prims') mesh of the joined world: a
    ``torch.distributed.device_mesh.DeviceMesh`` of shape ``(n_rays,
    n_prims)``, rank r at (r // n_prims, r % n_prims).  ``n_rays`` defaults
    to ``world_size // n_prims``.  A mesh that does not cover the world is a
    ``ValueError`` (JAX drops the devices past it; a rank here is a process
    that would wait for the others).  The mesh's device type follows the
    backend: "cuda" under NCCL, "cpu" under Gloo (whose groups carry the
    card's tensors too)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not tdist.is_initialized():
        raise RuntimeError("make_mesh needs a joined world: call dist.initialize(...) first")
    world = tdist.get_world_size()
    if n_rays is None:
        n_rays = world // n_prims
    if n_rays < 1 or n_prims < 1 or n_rays * n_prims != world:
        raise ValueError(f"a ({n_rays}, {n_prims}) mesh does not match the world of {world} "
                         "ranks")
    dtype = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dtype, (n_rays, n_prims), mesh_dim_names=AXES)


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it: its process group, this
    rank's index along it and its size, with the collectives the sharded
    routes run on it (the counterpart of an axis name under JAX's
    ``shard_map``: ``axis_index``, ``all_gather``, ``psum``)."""

    group: object
    rank: int
    size: int

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The axis's ``x`` concatenated along dim 0 in axis order, without
        a gradient (integer fields)."""
        return _all_gather(x, self.group, self.size)

    def all_gather_grad(self, x: torch.Tensor) -> torch.Tensor:
        """As :meth:`all_gather`, differentiable: the backward sums the
        cotangent over the axis and keeps this rank's slice (JAX's
        transpose, ``psum_scatter``)."""
        return _GatherSum.apply(x, self)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis, without a gradient (integer
        fields)."""
        return _all_reduce(x, self.group)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis, differentiable (the backward sums
        the cotangent over the axis)."""
        return _PSum.apply(x, self)


def mesh_axis(mesh, axis: str) -> MeshAxis:
    """``axis`` of ``mesh`` as a :class:`MeshAxis`."""
    dim = mesh.mesh_dim_names.index(axis)
    return MeshAxis(mesh.get_group(axis), int(mesh.get_local_rank(axis)), int(mesh.shape[dim]))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    tdist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x`` (a new tensor)."""
    out = x.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(out, group=group)
    return out


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[0]
        return _all_gather(x, axis.group, axis.size)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.axis.rank, ctx.n
        return _all_reduce(g, ctx.axis.group)[r * n:(r + 1) * n], None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_reduce(x, axis.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis.group), None


class _GatherOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, scale):
        ctx.axis, ctx.n, ctx.scale = axis, x.shape[0], scale
        return _all_gather(x, axis.group, axis.size)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.axis.rank, ctx.n
        return g[r * n:(r + 1) * n] * ctx.scale, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.clone() for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # one flat float64 sum over the axis for every parameter
        flat = torch.cat([g.reshape(-1).double() for g in gs])
        flat = _all_reduce(flat, ctx.axis.group)
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].reshape(g.shape).to(g.dtype))
            at += g.numel()
        return (None, *out)


def shard_range(total: int, axis: MeshAxis, quantum: int = 1) -> tuple[int, int]:
    """This rank's contiguous share of ``total`` items along ``axis``:
    ``(first, count)``, every rank's count the same, a multiple of
    ``quantum`` (JAX's tiles of 128 pixels, 512 rays); the last shard's
    items at or past ``total`` are padding."""
    count = -(-(-(-total // quantum)) // axis.size) * quantum
    return axis.rank * count, count


def gather_rays(x: torch.Tensor, mesh, axis: str = "rays") -> torch.Tensor:
    """The slices ``x`` (equal sizes, dim 0) of the ranks along ``axis``,
    concatenated in axis order, on every rank.  Differentiable: every rank
    computes the same loss from the gathered tensor, so the backward hands
    each rank the cotangent of its own slice with no reduction, divided by
    the ranks that trace the same slice (the mesh's other axis)."""
    ax = mesh_axis(mesh, axis)
    others = mesh.size() // ax.size
    return _GatherOwn.apply(x, ax, 1.0 / others)


def replicate(scene):
    """``scene`` with every tensor that requires grad passed through an
    identity whose backward sums the ranks' partial gradients over the
    world (the transpose of JAX's replicated ``in_specs=P()``): one flat
    float64 all-reduce for all of them."""
    tables = {}
    leaves = []
    for tf in dataclasses.fields(scene):
        tab = getattr(scene, tf.name)
        if not dataclasses.is_dataclass(tab):
            continue
        for f in dataclasses.fields(tab):
            v = getattr(tab, f.name)
            if isinstance(v, torch.Tensor) and v.requires_grad:
                leaves.append((tf.name, f.name, v))
    if not leaves:
        return scene
    world = MeshAxis(tdist.group.WORLD, tdist.get_rank(), tdist.get_world_size())
    outs = _Replicate.apply(world, *(v for _, _, v in leaves))
    for (tn, fn, _), v in zip(leaves, outs):
        tables.setdefault(tn, {})[fn] = v
    return dataclasses.replace(scene, **{tn: dataclasses.replace(getattr(scene, tn), **kv)
                                         for tn, kv in tables.items()})


# ---------------------------------------------------------------------------
# the primitive axis
# ---------------------------------------------------------------------------


def _axis_size(mesh_or_n, axis: str = "prims") -> int:
    if isinstance(mesh_or_n, int):
        return mesh_or_n
    return int(mesh_or_n.shape[mesh_or_n.mesh_dim_names.index(axis)])


def shard_spheres(scene, mesh_or_n):
    """Pad the sphere table so it divides the 'prims' axis (a mesh, or its
    size): the padding rows are inert, centres at 1e9 and radius 0 (they
    cannot hit), material 0."""
    n_prims = _axis_size(mesh_or_n)
    s = scene.spheres
    pad = (-s.center.shape[0]) % n_prims
    if pad == 0:
        return scene

    def grow(t, fill):
        return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                                        device=t.device)])

    spheres = dataclasses.replace(s, center=grow(s.center, 1e9), radius=grow(s.radius, 0.0),
                                  material=grow(s.material, 0))
    return dataclasses.replace(scene, spheres=spheres)


def _local_spheres(scene, axis: MeshAxis):
    """This rank's slice of the (padded) sphere table; the count stays the
    scene's (the sharded hit scans every row of the slice)."""
    s = scene.spheres
    rows = s.center.shape[0] // axis.size
    sl = slice(axis.rank * rows, (axis.rank + 1) * rows)
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        s, center=s.center[sl], radius=s.radius[sl], material=s.material[sl]))


def sharded_hit_fn(scene, mesh, *, include_boxes: bool = False, axis: str = "prims"):
    """Closest hit where ``scene``'s sphere table is this rank's slice along
    ``axis``: the sphere stage on the slice, the five winner fields
    all-gathered over the axis (two collectives: the float fields, which
    carry gradients, and the integer ones), and an argmin over the shards,
    whose first-occurrence rule lets the lowest shard (the lowest global
    index) win a tie, as the reference's first-wins scan does.  The
    winner's index is global (the slice's offset added).  Then
    ``closest_hit`` against planes and boxes with that sphere result."""
    from .ops.intersect import closest_hit, sphere_stage

    ax = mesh_axis(mesh, axis)

    def hit_fn(o, d):
        local_n = int(scene.spheres.center.shape[0])
        local = dataclasses.replace(scene.spheres, count=local_n)
        ts, ns, ms, is_, rl = sphere_stage(local, o, d)
        n = ts.shape[0]
        fl = ax.all_gather_grad(torch.cat([ts[:, None], ns], dim=1)).reshape(ax.size, n, 4)
        it = ax.all_gather(torch.stack([ms.to(torch.int32), is_ + ax.rank * local_n,
                                        rl.to(torch.int32)], dim=1)).reshape(ax.size, n, 3)
        pwin = torch.argmin(fl[:, :, 0].detach(), dim=0)
        ar = torch.arange(n, device=o.device)
        win_f, win_i = fl[pwin, ar], it[pwin, ar]
        sphere_result = (win_f[:, 0], win_f[:, 1:], win_i[:, 0], win_i[:, 1], win_i[:, 2] > 0)
        return closest_hit(scene.spheres, scene.planes, scene.boxes, o, d,
                           include_boxes=include_boxes, sphere_result=sphere_result)

    return hit_fn


# ---------------------------------------------------------------------------
# the sharded frame
# ---------------------------------------------------------------------------


def render_image_sharded(
    scene,
    size: tuple[int, int],
    key,
    mesh,
    *,
    personality: str = "mg",
    spp: Optional[int] = None,
    max_bounces: Optional[int] = None,
    rng_mode: str = "reference",
    ray_chunk: Optional[int] = None,
    gamma: bool = True,
    grad_mode: str = "autodiff",
    include_boxes: bool = False,
    device="cuda",
) -> torch.Tensor:
    """Path-traced frame sharded over ``mesh``: the whole (H, W, 3) float32
    frame on every rank, on ``device``.

    Equal bit for bit to :func:`rt_tpu_torch.integrator.render_image` with
    the same key and ``ray_chunk``: the pixels are padded to whole chunks
    per 'rays' rank, rank i renders chunks ``i * chunks_per_shard ..`` with
    that chunk offset folded into the key, and with a 'prims' axis the
    sphere table is sharded (:func:`sharded_hit_fn`; under
    ``grad_mode="replay"`` the global-winner replay,
    ``replay_radiance(prims_axis=...)``).  The default ``ray_chunk`` is
    JAX's: the integrator's, at most the rank's share of the pixels (and at
    least 1024).  Autograd through the frame reaches the tensors of a
    ``scene`` already on ``device``, the gradients summed over the world
    (module note)."""
    from .integrator import _device, _pixel_grid, default_ray_chunk, render_pixels
    from .ops.intersect import sqrt_rn

    dev = _device(device)
    w, h = size
    spp = scene.samples_per_pixel if spp is None else spp
    max_bounces = scene.max_bounces if max_bounces is None else max_bounces
    n = w * h
    rays, prims = mesh_axis(mesh, "rays"), mesh_axis(mesh, "prims")
    if ray_chunk is None:
        ray_chunk = min(default_ray_chunk(scene), max(1024, -(-n // rays.size)))
    scene = shard_spheres(replicate(scene.to(dev)), prims.size)
    hit_fn = replay_axis = None
    if prims.size > 1:
        scene = _local_spheres(scene, prims)
        hit_fn = sharded_hit_fn(scene, mesh, include_boxes=include_boxes)
        replay_axis = prims if grad_mode == "replay" else None

    # pad the pixels so that every rank gets the same number of whole chunks
    stride = ray_chunk * rays.size
    per_rank = -(-n // stride) * ray_chunk
    grid = _pixel_grid(size, dev)
    grid = torch.cat([grid, grid.new_zeros((per_rank * rays.size - n, 2))])
    local = grid[rays.rank * per_rank:(rays.rank + 1) * per_rank]
    rad = render_pixels(scene, size, local, key, spp=spp, personality=personality,
                        max_bounces=max_bounces, rng_mode=rng_mode, ray_chunk=ray_chunk,
                        hit_fn=hit_fn, chunk_offset=rays.rank * (per_rank // ray_chunk),
                        grad_mode=grad_mode, include_boxes=include_boxes,
                        replay_prims_axis=replay_axis)
    img = gather_rays(rad, mesh)[:n]
    if gamma:
        img = sqrt_rn(torch.clamp_min(img, 0.0))
    return img.reshape(h, w, 3)


# ---------------------------------------------------------------------------
# local ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _rank_main(fn, args, rank, n_ranks, port, device, threads, timeout, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(device=device, timeout=timeout, init_method=f"tcp://127.0.0.1:{port}",
                   world_size=n_ranks, rank=rank, local_rank=rank)
        results.put((rank, True, pickle.dumps(fn(*args))))
    except Exception:  # the parent reports it and stops the other ranks
        results.put((rank, False, traceback.format_exc()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def run_local(fn, n_ranks: int, *args, device="cuda", timeout: Optional[float] = 120.0,
              collective_timeout: float = _TIMEOUT, threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` local ranks, each a process of its
    own (the ``spawn`` start method: forking after CUDA is initialised
    fails) that has joined a world of ``n_ranks`` by TCP on a free local
    port (:func:`initialize` on ``device``, collectives bounded by
    ``collective_timeout``): the list of the ranks' results, in rank order.
    ``fn`` and its results must pickle (``fn`` a module-level function);
    ``threads`` sets each rank's torch threads.  A rank that raises or
    dies, or a launch that outlasts ``timeout`` seconds (None: no deadline,
    the collectives' own still holds), stops every rank and raises: a
    partial result is never returned."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, n_ranks, port, str(device), threads,
                               collective_timeout, results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    got = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    done = False
    try:
        while len(got) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except _queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"run_local: {n_ranks} ranks outlasted {timeout} s "
                                       f"({sorted(got)} done)") from None
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in got]
                if dead:
                    raise RuntimeError(f"run_local: rank {dead[0]} died "
                                       f"(exit code {procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"run_local: rank {rank} failed:\n{payload}")
            got[rank] = pickle.loads(payload)
        done = True
    finally:
        for p in procs:
            p.join(timeout=10.0 if done else 0.0)
            if p.is_alive():
                p.terminate()
                p.join()
        results.close()
    return [got[r] for r in range(n_ranks)]
