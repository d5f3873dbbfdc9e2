"""The ranks' side of tests/test_torch_dist*.py: functions that
``rt_tpu_torch.dist.run_local`` runs in each rank of a Gloo world on the
CPU.  Imports neither JAX nor the JAX package (each rank is a process of
its own that imports this module); the test files compare the results with
the JAX package and with the port's unsharded routes in the pytest
process."""

import contextlib
import io
import pathlib

import torch
import torch.distributed as tdist

import rt_tpu_torch as rt
from rt_tpu_torch import cli, diff, dist
from rt_tpu_torch.ops import blockwise as BW
from rt_tpu_torch.ops import blockwise_grad as BG
from rt_tpu_torch.ops import wavefront as WF
from rt_tpu_torch.ops import wavefront_grad as WG

SCENES = pathlib.Path(__file__).resolve().parent.parent / "scenes"
MESHES = ((4, 1), (2, 2), (1, 4))
# the JAX package's tests/test_dist.py shapes
BASIC = dict(size=(64, 32), seed=5, spp=2, max_bounces=4, ray_chunk=256)
PROC = dict(size=(32, 16), seed=1, spp=1, max_bounces=3, ray_chunk=128)
GRAD = dict(size=(32, 16), seed=3, spp=1, max_bounces=3, ray_chunk=128)
CLI_ARGS = ["--scene", str(SCENES / "basic.toml"), "--size", "32x24", "--spp", "2",
            "--bounces", "3", "--seed", "4", "--device", "cpu"]


def basic():
    return rt.load(str(SCENES / "basic.toml"))


def proc100():
    return rt.scene.make_procedural_scene(100, spp=1)


def render(scene, mesh, case, **kw):
    """The sharded frame of ``case`` (BASIC, PROC, GRAD's shape), or the
    unsharded one without a mesh."""
    c = dict(case)
    size, key = c.pop("size"), rt.rng.make_key(c.pop("seed"))
    if mesh is None:
        return rt.integrator.render_image(scene, size, key, device="cpu", **c, **kw)
    return dist.render_image_sharded(scene, size, key, mesh, device="cpu", **c, **kw)


def grads(mesh, grad_mode):
    """``(loss, grads)`` of the MSE against a black frame on GRAD's shape,
    through the sharded renderer (or the unsharded one without a mesh)."""
    s = proc100()
    c = dict(GRAD)
    size, key = c.pop("size"), rt.rng.make_key(c.pop("seed"))
    target = torch.zeros((size[1], size[0], 3))
    fn = None if mesh is None else (
        lambda sc, sz, k, **o: dist.render_image_sharded(sc, sz, k, mesh, **o))
    return diff.loss_and_grad(diff.extract_params(s), s, target, size, key, render_fn=fn,
                              grad_mode=grad_mode, device="cpu", **c)


def jnp_rank(out_dir: str) -> dict:
    """test_torch_dist.py's world of 4 ranks: the meshes, the sharded frames
    on every mesh, the replay value, the gradients on (2, 2) in both modes,
    and ``--mesh 2x2`` through the CLI (rank 0 writes ``cli_mesh.npy``)."""
    res = {"rank": tdist.get_rank(),
           "mesh_41": tuple(dist.make_mesh(4, 1).shape),
           "mesh_prims2": tuple(dist.make_mesh(n_prims=2).shape)}
    try:
        dist.make_mesh(3, 1)
    except ValueError as ex:
        res["mismatch"] = str(ex)
    for shape in MESHES:
        mesh = dist.make_mesh(*shape)
        res[("basic", shape)] = render(basic(), mesh, BASIC)
        res[("proc", shape)] = render(proc100(), mesh, PROC)
    mesh = dist.make_mesh(2, 2)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res["replay_value"] = render(proc100(), mesh, PROC, grad_mode="replay")
        for mode in ("autodiff", "replay"):
            res[("grad", mode)] = grads(mesh, mode)
    res["stderr"] = err.getvalue()
    res["cli_rc"] = cli.main(CLI_ARGS + ["--mesh", "2x2", "--out", f"{out_dir}/cli_mesh.npy"])
    return res


def _box_scene():
    from test_torch_common import BOX_TOML

    return rt.loads((SCENES / "basic.toml").read_text() + BOX_TOML)


# (name, route, scene, size, seed, options): ragged frames (37x23: the last
# shard is padded), --boxes, a live-prefix shrink at bounce 1, and the
# wavefront's chunk cap lowered to 1000 rays ("cap"), so that it binds
FRAMES = (
    ("bw ragged", "bw", "basic", (37, 23), 3, {}),
    ("bw proc", "bw", "proc", (32, 16), 5, {}),
    ("wf ragged", "wf", "basic", (37, 23), 3, {}),
    ("wf proc", "wf", "proc", (32, 16), 5, {}),
    ("wf boxes", "wf", "box", (37, 23), 1, {"include_boxes": True}),
    ("wf shrink", "wf", "basic", (37, 23), 2, {"sort_schedule": (1, 2), "shrink_at": 1}),
    ("wf capped", "wf", "basic", (37, 23), 3, {"cap": 1000}),
)
STEP = dict(size=(24, 16), spp=2, max_bounces=3, seed=5, lr=1e-2)


def kernel_frame(case, mesh=None):
    """The frame of one FRAMES case, sharded over ``mesh['rays']`` or
    unsharded."""
    _, route, scene, size, seed, opts = case
    scene = {"basic": basic, "proc": proc100, "box": _box_scene}[scene]()
    opts = dict(opts)
    cap = opts.pop("cap", WF._HBM_RAY_CAP)
    kw = dict(spp=2, max_bounces=4, device="cpu", **opts)
    if route == "bw":
        if mesh is None:
            return BW.render_forward_blockwise(scene, size, seed, **kw)
        return BW.render_forward_blockwise_sharded(scene, size, mesh, seed, **kw)
    default, WF._HBM_RAY_CAP = WF._HBM_RAY_CAP, cap
    try:
        if mesh is None:
            return WF.render_forward_wavefront(scene, size, seed, **kw)
        return WF.render_forward_wavefront_sharded(scene, size, mesh, seed, **kw)
    finally:
        WF._HBM_RAY_CAP = default


def kernel_step(route, mesh=None, scene=None, size=None, spp=None, max_bounces=None,
                target=None):
    """One Adam step of the blockwise ("bw") or wavefront ("wf") train step
    from the scene's params: ``(loss, params after the step)``."""
    scene = basic() if scene is None else scene
    size = STEP["size"] if size is None else size
    target = torch.zeros((size[1], size[0], 3)) if target is None else target
    params = {k: v.clone() for k, v in diff.extract_params(scene).items()}
    opt = torch.optim.Adam(list(params.values()), lr=STEP["lr"])
    make = BG.make_bw_train_step if route == "bw" else WG.make_wf_train_step
    step = make(opt, scene, target, size, spp=STEP["spp"] if spp is None else spp,
                max_bounces=STEP["max_bounces"] if max_bounces is None else max_bounces,
                device="cpu", mesh=mesh)
    loss = step(params, STEP["seed"])
    return float(loss), {k: v.detach().clone() for k, v in params.items()}


def kernels_rank(jax_case: dict) -> dict:
    """test_torch_dist_kernels.py's world of 4 ranks: every FRAMES case and
    both train steps sharded over 4 ranks ((4, 1)) and over 2 ((2, 2), whose
    'rays' axis has 2), and the blockwise step of ``jax_case`` on (2, 2)."""
    res = {}
    for shape in ((4, 1), (2, 2)):
        mesh = dist.make_mesh(*shape)
        for case in FRAMES:
            res[(case[0], shape)] = kernel_frame(case, mesh)
        for route in ("bw", "wf"):
            res[(route, shape)] = kernel_step(route, mesh)
    c = dict(jax_case)
    scene = rt.scene.make_procedural_scene(c.pop("n_spheres"))
    res["jax_case"] = kernel_step("bw", dist.make_mesh(2, 2), scene, **c)
    return res
