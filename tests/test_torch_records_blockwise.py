"""The blockwise record kernel's plain PyTorch version (queue 2 row 6)
against the JAX blockwise record kernel (``render_record_blockwise(
rng_impl="hash", interpret=True)``), against the port's unrolled record
tile, and past the unrolled kernel's 640 primitives."""

import numpy as np
import pytest
import torch

import rt_tpu_torch
from rt_tpu.ops import pallas_blockwise as jb
from rt_tpu_torch.ops import blockwise as tb
from rt_tpu_torch.ops import render as tr
from test_torch_common import (BOX_TOML, PLANES_TOML, SCENES, assert_frames_close,
                               assert_records_match, box_scene_toml, tiles_to_flat)
from test_torch_ops import jax_scene

SIZE, BOUNCES = (24, 16), 3


@pytest.mark.parametrize("name,personality,boxes,center", [
    ("basic.toml", "mg", False, False),
    ("dielectric.toml", "sm", False, True),
    ("box", "mg", True, False),
])
def test_blockwise_record_tile_matches_jax(name, personality, boxes, center):
    n = SIZE[0] * SIZE[1]
    js = jax_scene(name)
    kw = dict(personality=personality, max_bounces=BOUNCES, center_sample=center,
              include_boxes=boxes)
    jrad, jrecs = jb.render_record_blockwise(js, SIZE, 9, rng_impl="hash", interpret=True, **kw)
    rad, recs = tb.render_record_blockwise(rt_tpu_torch.from_jax_scene(js), SIZE, 9,
                                           device="cpu", **kw)
    assert_records_match(recs, jrecs, n)
    assert_frames_close(rad, tiles_to_flat(jrad, n).T.reshape(SIZE[1], SIZE[0], 3))


def _scene(name):
    if name == "planes":
        return rt_tpu_torch.loads(PLANES_TOML)
    if name == "box":
        return rt_tpu_torch.loads((SCENES / "basic.toml").read_text() + BOX_TOML)
    return rt_tpu_torch.load(str(SCENES / name))


@pytest.mark.parametrize("name,personality,boxes,rng_mode", [
    ("basic.toml", "mg", False, "reference"),
    ("dielectric.toml", "sm", False, "reference"),
    ("cornell_spheres.toml", "sm", False, "sphere"),
    ("planes", "mg", False, "reference"),
    ("box", "sm", True, "reference"),
])
def test_blockwise_and_unrolled_records_agree(name, personality, boxes, rng_mode):
    """The two record tiles trace the same paths: the radiance, kind, idx,
    draws and jitter are equal (torch.equal), and so is every bit that the
    replay reads.  The JAX record kernels themselves differ on two bits off
    those lanes, and each plain tile follows its own: the root bit where no
    sphere won (the blockwise kernel's comes from an all-zero sphere row),
    and the reflect bit of a scene without a dielectric (the unrolled
    kernel leaves it 0)."""
    scene = _scene(name)
    size = (32, 24)
    s_cols, p_cols = tr._flatten_primitives(scene, personality)
    has_die = 2.0 in np.concatenate(
        [s_cols[9], p_cols[9], tr._flatten_boxes(scene, personality)[11] if boxes else []])
    kw = dict(personality=personality, max_bounces=5, rng_mode=rng_mode, include_boxes=boxes,
              device="cpu")
    for center in (True, False):
        rad_u, ru = tr.render_record(scene, size, 4, center_sample=center, **kw)
        rad_b, rb = tb.render_record_blockwise(scene, size, 4, center_sample=center, **kw)
        assert torch.equal(rad_u, rad_b)
        for k in ru:
            if k != "bits":
                assert torch.equal(ru[k], rb[k]), k
        assert torch.equal(ru["bits"] & ~3, rb["bits"] & ~3)
        sphere = ru["kind"] == 1
        assert torch.equal((ru["bits"] & 1)[sphere], (rb["bits"] & 1)[sphere])
        if has_die:
            assert torch.equal(ru["bits"] & 2, rb["bits"] & 2)
        else:
            assert ((ru["bits"] & 2) == 0).all()
    assert has_die == (name in ("dielectric.toml", "cornell_spheres.toml"))


def test_blockwise_record_past_the_unrolled_cap():
    """660 spheres and 24 boxes (tests/test_pallas_blockwise.py's box scene):
    past the render kernel, through the blockwise record tile, with box
    winners in the records."""
    scene = rt_tpu_torch.loads(box_scene_toml(660, 24))
    assert not tr.supported(scene, include_boxes=True)
    assert tb.blockwise_supported(scene, include_boxes=True)
    with pytest.raises(ValueError, match="exceeds"):
        tr.render_record(scene, (8, 8), 0, include_boxes=True, device="cpu")
    rad, recs = tb.render_record_blockwise(scene, (16, 12), 2, max_bounces=2, include_boxes=True,
                                           device="cpu")
    assert torch.isfinite(rad).all()
    assert (recs["kind"] == 3).any() and (recs["kind"] == 1).any()
    assert int(recs["idx"][recs["kind"] == 3].max()) < 24
    assert int(recs["idx"][recs["kind"] == 1].max()) < 660
    assert np.isfinite(recs["urx"].numpy()).all()
