"""The CUDA kernels (forward render, fused gradient) against their plain
PyTorch versions, both on the card, at small sizes.  Needs an NVIDIA GPU with nvcc (marker ``cuda``);
without one every test skips.  On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine need not have.)
chip_smoke.py runs the same comparison at the main path's shapes.
"""

import numpy as np
import pytest
import torch

import rt_tpu_torch
from rt_tpu_torch import diff
from rt_tpu_torch.ops import grad as tg
from rt_tpu_torch.ops import render as tr
from test_torch_common import BOX_TOML, PLANES_TOML, SCENES, assert_frames_close

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _scene(name):
    if name == "planes":
        return rt_tpu_torch.loads(PLANES_TOML)
    if name == "box":
        return rt_tpu_torch.loads((SCENES / "basic.toml").read_text() + BOX_TOML)
    if name == "proc64":
        return rt_tpu_torch.scene.make_procedural_scene(64)
    return rt_tpu_torch.load(str(SCENES / name))


@pytest.mark.parametrize("name,personality,include_boxes,rng_mode", [
    ("basic.toml", "mg", False, "reference"),
    ("dielectric.toml", "sm", False, "reference"),
    ("cornell_spheres.toml", "sm", False, "sphere"),
    ("planes", "mg", False, "reference"),
    ("box", "mg", True, "reference"),
    ("proc64", "mg", False, "reference"),
])
def test_kernel_matches_plain(cuda, name, personality, include_boxes, rng_mode):
    scene = _scene(name)
    s_cols, p_cols = tr._flatten_primitives(scene, personality)
    b_cols = (tr._flatten_boxes(scene, personality) if include_boxes
              else np.zeros((12, 0), np.float32))
    size = (48, 32)
    args = [torch.from_numpy(np.ascontiguousarray(c.T)).to(cuda) for c in (s_cols, p_cols, b_cols)]
    args += [torch.from_numpy(tr._pack_camera(scene.camera, size)).to(cuda),
             torch.tensor([5, -9], dtype=torch.int32, device=cuda)]
    kw = dict(size=size, spp=3, max_bounces=5, center_sample=True, rng_mode=rng_mode)
    before = tr.render_tile.launches
    got = tr.render_tile(*args, **kw)
    assert tr.render_tile.launches == before + 1
    want = tr.render_tile_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == (2, 32, 48, 3) and torch.isfinite(got).all()
    # built with --fmad=false and 1/sqrtf, the kernel rounds every operation
    # as the plain version does on the card, so the two agree bit for bit
    diff = (got - want).abs()
    assert torch.equal(got, want), (
        f"{int((diff.amax(-1) > 0).sum())} pixels differ (max abs diff {diff.max().item()})")


def test_entry_points_launch_the_kernel(cuda):
    scene = _scene("basic.toml")
    before = tr.render_tile.launches
    img = tr.render_forward(scene, (40, 30), spp=6, max_bounces=4, device=cuda)
    assert tr.render_tile.launches == before + 2  # two sample chunks
    assert img.device.type == "cuda" and img.shape == (30, 40, 3)
    step = tr.make_render_step(scene, (40, 30), spp=6, max_bounces=4, frames=2, device=cuda)
    frames = step(seed=0)
    assert frames.shape == (2, 30, 40, 3)
    torch.testing.assert_close(frames[0], img, rtol=0, atol=0)
    assert_frames_close(img.cpu(), tr.render_forward(scene, (40, 30), spp=6, max_bounces=4,
                                                     device="cpu"))


def test_wrapper_rejects_bad_inputs(cuda):
    scene = _scene("basic.toml")
    s_cols, p_cols = tr._flatten_primitives(scene, "mg")
    sp = torch.from_numpy(np.ascontiguousarray(s_cols.T)).to(cuda)
    pl = torch.from_numpy(np.ascontiguousarray(p_cols.T)).to(cuda)
    bx = torch.zeros((0, 12), device=cuda)
    cam = torch.from_numpy(tr._pack_camera(scene.camera, (8, 8))).to(cuda)
    seeds = torch.tensor([0], dtype=torch.int32, device=cuda)
    kw = dict(size=(8, 8), spp=1, max_bounces=1, center_sample=True)
    with pytest.raises(ValueError, match="seeds"):
        tr.render_tile(sp, pl, bx, cam, seeds.long(), **kw)
    with pytest.raises(ValueError, match="cam"):
        tr.render_tile(sp, pl, bx, cam.cpu(), seeds, **kw)
    with pytest.raises(ValueError, match="spheres"):
        tr.render_tile(sp.t(), pl, bx, cam, seeds, **kw)


def _grad_args(cuda, name, personality, size, seed=1):
    scene = _scene(name)
    s_cols, p_cols = tr._flatten_primitives(scene, personality)
    sp, pl = (torch.from_numpy(np.ascontiguousarray(c.T)).to(cuda) for c in (s_cols, p_cols))
    cam = torch.from_numpy(tr._pack_camera(scene.camera, size)).to(cuda)
    w, h = size
    pix = torch.from_numpy(np.random.default_rng(seed).uniform(0, 0.5, (h, w, 3))
                           .astype(np.float32)).to(cuda)
    return sp, pl, cam, pix


def _assert_within_l1(got, want, l1):
    # same per-ray arithmetic (--fmad=false, same expression order); only
    # the order of the sums over pixels and samples differs, and the
    # kernel's per-primitive sums use shared-memory atomics: each entry
    # agrees within 1e-5 of the sum of its contributions' magnitudes
    for g, w_, l in zip(got, want, l1):
        assert torch.isfinite(g).all()
        assert ((g - w_).abs() <= 1e-5 * l).all(), ((g - w_).abs() / l.clamp_min(1e-30)).max()


@pytest.mark.parametrize("name,personality,rng_mode", [
    ("basic.toml", "mg", "reference"),
    ("cornell_spheres.toml", "sm", "sphere"),
    ("planes", "mg", "reference"),
])
def test_mono_kernel_matches_plain(cuda, name, personality, rng_mode):
    size = (48, 32)
    sp, pl, cam, tgt = _grad_args(cuda, name, personality, size)
    seeds = torch.tensor([3, -8, 40000], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=6, rng_mode=rng_mode)
    before = tg.mse_step_tile.launches
    got = tg.mse_step_tile(sp, pl, cam, seeds, tgt, **kw)
    assert tg.mse_step_tile.launches == before + 1
    want, l1 = tg.mse_step_tile_plain(sp, pl, cam, seeds, tgt, with_l1=True, **kw)
    torch.cuda.synchronize()
    _assert_within_l1(got, want, l1)


@pytest.mark.parametrize("name,personality,center", [
    ("dielectric.toml", "sm", True),
    ("proc64", "mg", False),
])
def test_grad_kernel_matches_plain(cuda, name, personality, center):
    size = (48, 32)
    sp, pl, cam, cot = _grad_args(cuda, name, personality, size)
    seeds = torch.tensor([77], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=6, center_sample=center)
    before = tg.grad_tile.launches
    got = tg.grad_tile(sp, pl, cam, seeds, cot * 1e-4, **kw)
    assert tg.grad_tile.launches == before + 1
    want, l1 = tg.grad_tile_plain(sp, pl, cam, seeds, cot * 1e-4, with_l1=True, **kw)
    torch.cuda.synchronize()
    _assert_within_l1(got, want, l1)


def test_make_mse_step_launches(cuda):
    """The mono route launches its kernel once per step; the per-sample
    route launches the render kernel and the gradient kernel once per
    sample each."""
    scene = _scene("dielectric.toml")
    params = diff.extract_params(scene)
    size = (40, 30)
    target = torch.zeros((30, 40, 3), device=cuda)
    counts = lambda: (tg.mse_step_tile.launches, tr.render_tile.launches, tg.grad_tile.launches)
    mono = tg.make_mse_step(params, scene, target, size, spp=4, max_bounces=8,
                            personality="sm", device=cuda)
    before = counts()
    loss, grads = mono(seed=1)
    assert mono.mode == "mono"
    assert counts() == (before[0] + 1, before[1], before[2])
    multi = tg.make_mse_step(params, scene, target, size, spp=64, max_bounces=8,
                             personality="sm", device=cuda)
    before = counts()
    loss64, grads64 = multi(seed=1)
    assert multi.mode == "multi"
    assert counts() == (before[0], before[1] + 64, before[2] + 64)
    for g in (grads, grads64):
        assert set(g) == set(params) and all(torch.isfinite(v).all() for v in g.values())
    assert torch.isfinite(loss) and torch.isfinite(loss64)


def _bw_tables(cuda, scene, personality, include_boxes=False):
    from rt_tpu_torch.ops import blockwise as tb

    return tb._device_tables(scene, personality, include_boxes, cuda)


@pytest.mark.parametrize("name,personality,include_boxes,rng_mode", [
    ("basic.toml", "mg", False, "reference"),
    ("cornell_spheres.toml", "sm", False, "sphere"),
    ("box", "mg", True, "reference"),
    ("proc700", "mg", False, "reference"),
])
def test_blockwise_kernel_matches_plain(cuda, name, personality, include_boxes, rng_mode):
    from rt_tpu_torch.ops import blockwise as tb

    scene = (rt_tpu_torch.scene.make_procedural_scene(700) if name == "proc700"
             else _scene(name))
    sp, pl, bx, counts = _bw_tables(cuda, scene, personality, include_boxes)
    size = (48, 32)
    cam = torch.from_numpy(tr._pack_camera(scene.camera, size)).to(cuda)
    seeds = torch.tensor([-9], dtype=torch.int32, device=cuda)
    kw = dict(size=size, spp=3, max_bounces=5, center_sample=True, rng_mode=rng_mode)
    before = tb.render_blockwise_tile.launches
    got = tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, **kw)
    assert tb.render_blockwise_tile.launches == before + 1
    want = tb.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, **kw)
    torch.cuda.synchronize()
    assert got.shape == (32, 48, 3) and torch.isfinite(got).all()
    # the render kernel's per-pixel code (csrc/trace.cuh) with --fmad=false:
    # bit for bit, as the render kernel
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("name,personality,center", [
    ("cornell_spheres.toml", "sm", True),
    ("proc700", "mg", False),
])
def test_bw_grad_kernel_matches_plain(cuda, name, personality, center):
    from rt_tpu_torch.ops import blockwise_grad as tbg

    scene = (rt_tpu_torch.scene.make_procedural_scene(700) if name == "proc700"
             else _scene(name))
    sp, pl, _, counts = _bw_tables(cuda, scene, personality)
    size = (48, 32)
    cam = torch.from_numpy(tr._pack_camera(scene.camera, size)).to(cuda)
    cot = torch.from_numpy(np.random.default_rng(4).uniform(0, 1e-4, (32, 48, 3))
                           .astype(np.float32)).to(cuda)
    seeds = torch.tensor([77], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=6, center_sample=center)
    before = tbg.bw_grad_tile.launches
    got = tbg.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, **kw)
    assert tbg.bw_grad_tile.launches == before + 1
    twice = tbg.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, out=tuple(g.clone() for g in got),
                             **kw)
    want, l1 = tbg.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot, with_l1=True, **kw)
    torch.cuda.synchronize()
    # per-row gradients are added with global atomics: within 1e-5 x L1
    _assert_within_l1(got, want, l1)
    _assert_within_l1(twice, [2 * w_ for w_ in want], [2 * l for l in l1])


def test_blockwise_entry_points_launch_the_kernels(cuda):
    """The 1000-sphere scene takes the blockwise route (one forward launch
    per 4-sample chunk); the blockwise step launches the forward and the
    gradient kernel once per sample; the train step does the same and
    updates the params in place."""
    from rt_tpu_torch import renderer as treg
    from rt_tpu_torch import train as ttrain
    from rt_tpu_torch.ops import blockwise as tb
    from rt_tpu_torch.ops import blockwise_grad as tbg

    big = rt_tpu_torch.scene.make_procedural_scene(1000)
    assert treg.auto_route(big, "cuda") == "blockwise"
    counts = lambda: (tb.render_blockwise_tile.launches, tbg.bw_grad_tile.launches)
    before = counts()
    img = treg.create("mg_auto")(big, (40, 30), spp=6, max_bounces=4, device=cuda)
    assert counts() == (before[0] + 2, before[1])
    assert img.shape == (30, 40, 3) and torch.isfinite(img).all()
    assert_frames_close(img.cpu(), tb.render_forward_blockwise(big, (40, 30), spp=6, max_bounces=4,
                                                               device="cpu"))
    scene = rt_tpu_torch.scene.make_procedural_scene(200)
    target = tb.render_forward_blockwise(scene, (40, 30), seed=3, spp=2, max_bounces=4,
                                         gamma=False, device=cuda)
    params = {"materials.albedo": torch.full_like(scene.materials.albedo, 0.5).to(cuda)}
    before = counts()
    loss, grads = tbg.bw_mse_loss_and_grad(params, scene, target, (40, 30), spp=3,
                                           max_bounces=4, device=cuda)
    assert counts() == (before[0] + 3, before[1] + 3)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
    opt = torch.optim.Adam(list(params.values()), lr=5e-2, foreach=True)
    step = ttrain.make_kernel_train_step(opt, scene, target, (40, 30), spp=3, max_bounces=4,
                                         device=cuda)
    start = params["materials.albedo"].clone()
    before = counts()
    losses = [float(step(params, i)) for i in range(4)]
    assert counts() == (before[0] + 12, before[1] + 12)
    assert not torch.equal(params["materials.albedo"], start) and losses[-1] < losses[0]
