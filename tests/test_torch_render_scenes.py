"""The forward kernel's plain PyTorch version against the JAX megakernel
(interpret mode, hash RNG): dielectrics under sm, the plane scan and its
tie-break with spheres, the --boxes slab test, and rng_mode="sphere"."""

import pytest

import rt_tpu_torch
from rt_tpu_torch.ops import render as tr
from test_torch_common import assert_frames_close
from test_torch_ops import jax_frame, jax_scene


@pytest.mark.parametrize("name,personality,size,opts", [
    ("dielectric.toml", "sm", (24, 16), {}),
    ("planes", "mg", (32, 24), {}),
    ("box", "mg", (32, 24), {"include_boxes": True}),
    ("basic.toml", "mg", (16, 8), {"rng_mode": "sphere"}),
])
def test_scene_frames_match_jax(name, personality, size, opts):
    js = jax_scene(name)
    kw = dict(spp=4, max_bounces=3, seed=1, personality=personality, **opts)
    want = jax_frame(js, size, **kw)
    got = tr.render_forward(rt_tpu_torch.from_jax_scene(js), size, device="cpu", **kw)
    assert_frames_close(got, want)
