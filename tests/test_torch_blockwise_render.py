"""The blockwise forward entry point's plain PyTorch path against the JAX
blockwise kernel (``render_forward_blockwise(rng_impl="hash",
interpret=True)``): planes and dielectrics under sm (the plane tie rule),
and the --boxes slab scan."""

import numpy as np
import pytest

import rt_tpu_torch
from rt_tpu.ops import pallas_blockwise as jb
from rt_tpu_torch.ops import blockwise as tb
from test_torch_common import assert_frames_close
from test_torch_ops import jax_scene


@pytest.mark.parametrize("name,personality,opts", [
    ("cornell_spheres.toml", "sm", {}),
    ("box", "mg", {"include_boxes": True}),
])
def test_blockwise_frames_match_jax(name, personality, opts):
    js = jax_scene(name)
    size = (16, 8)
    kw = dict(spp=4, max_bounces=4, seed=7, personality=personality, **opts)
    want = np.asarray(jb.render_forward_blockwise(js, size, rng_impl="hash", interpret=True,
                                                  **kw))
    got = tb.render_forward_blockwise(rt_tpu_torch.from_jax_scene(js), size, device="cpu", **kw)
    assert got.shape == (8, 16, 3)
    assert_frames_close(got, want)
