"""The CUDA forward kernel against its plain PyTorch version, both on the
card, at small sizes.  Needs an NVIDIA GPU with nvcc (marker ``cuda``);
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
