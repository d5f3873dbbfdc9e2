"""The forward kernel's plain PyTorch version against the JAX megakernel
(interpret mode, hash RNG) on scenes/basic.toml with the mg personality."""

import numpy as np
import torch

import rt_tpu_torch
from rt_tpu_torch.ops import render as tr
from rt_tpu_torch.ops import tables as tt
from test_torch_common import assert_frames_close
from test_torch_ops import jax_frame, jax_scene


def test_basic_mg_one_chunk():
    """32x24, 4 spp, 3 bounces: one kernel call.  Checks the raw chunk sum
    of render_tile_plain, render_forward on the CPU, and the gamma step."""
    size, spp, bounces = (32, 24), 4, 3
    js = jax_scene("basic.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    want = jax_frame(js, size, spp=spp, max_bounces=bounces, gamma=False)

    tile = tr.render_tile_plain(
        *tt._unrolled_tables(ts, "mg", False, torch.device("cpu")),
        torch.from_numpy(tt._pack_camera(ts.camera, size)),
        torch.tensor([0], dtype=torch.int32), size=size, spp=spp, max_bounces=bounces,
        center_sample=True)
    assert tile.shape == (1, 24, 32, 3)
    assert_frames_close(tile[0] * float(np.float32(1.0 / spp)), want)

    lin = tr.render_forward(ts, size, spp=spp, max_bounces=bounces, gamma=False, device="cpu")
    assert_frames_close(lin, want)
    img = tr.render_forward(ts, size, spp=spp, max_bounces=bounces, device="cpu")
    assert img.shape == (24, 32, 3) and img.device.type == "cpu"
    assert torch.equal(img, torch.sqrt(torch.clamp_min(lin, 0.0)))


def test_basic_mg_two_chunks():
    """6 spp = chunks of 4 and 2 samples: the LCG seed chain, and the centre
    sample in the first chunk only."""
    size = (32, 24)
    js = jax_scene("basic.toml")
    want = jax_frame(js, size, spp=6, max_bounces=3, seed=3)
    got = tr.render_forward(rt_tpu_torch.from_jax_scene(js), size, seed=3, spp=6,
                            max_bounces=3, device="cpu")
    assert_frames_close(got, want)
