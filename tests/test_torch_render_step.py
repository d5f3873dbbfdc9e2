"""The port's entry points against the JAX package's: the 64-sphere scene
(the JAX kernel's dead-tile early-out), make_render_step with batched
frames, and the CLI from TOML scene to image file."""

import numpy as np
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu.ops import pallas_render as jr
from rt_tpu_torch.cli import main
from rt_tpu_torch.ops import render as tr
from test_torch_common import SCENES, assert_frames_close
from test_torch_ops import jax_frame, jax_scene


def test_procedural_64_early_out():
    js = rt_tpu.scene.make_procedural_scene(64)
    want = jax_frame(js, (16, 8), spp=1, max_bounces=2)
    got = tr.render_forward(rt_tpu_torch.from_jax_scene(js), (16, 8), spp=1, max_bounces=2,
                            device="cpu")
    assert_frames_close(got, want)


def test_make_render_step_two_frames():
    js = jax_scene("basic.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    kw = dict(spp=2, max_bounces=2, frames=2)
    want = np.asarray(jr.make_render_step(js, (16, 8), rng_impl="hash", interpret=True,
                                          rows=8, **kw)(seed=5))
    step = tr.make_render_step(ts, (16, 8), device="cpu", **kw)
    got = step(seed=5)
    assert got.shape == (2, 8, 16, 3)
    assert_frames_close(got, want)
    # frame 0 of a batch reproduces the unbatched render; frame 1 differs
    single = tr.render_forward(ts, (16, 8), seed=5, spp=2, max_bounces=2, device="cpu")
    assert torch.equal(got[0], single)
    assert not torch.equal(got[1], single)
    # a moved camera renders through the same step
    cam = rt_tpu_torch.scene.Camera.from_pose([0.0, 1.0, 4.0], [0.0, 0.0, -1.0])
    assert not torch.equal(step(seed=5, camera=cam), got)


def test_cli_frame_matches_jax(tmp_path, capsys):
    out = tmp_path / "img.npy"
    rc = main(["--scene", str(SCENES / "basic.toml"), "--renderer", "mg_auto",
               "--size", "16x12", "--spp", "2", "--bounces", "2", "--seed", "1",
               "--device", "cpu", "--out", str(out)])
    assert rc == 0
    assert "created renderer: mg_auto" in capsys.readouterr().out
    want = jax_frame(jax_scene("basic.toml"), (16, 12), spp=2, max_bounces=2, seed=1)
    assert_frames_close(np.load(out), want)
