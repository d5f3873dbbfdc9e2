"""The wavefront forward entry point's plain PyTorch path against the JAX
wavefront kernel (``render_forward_wavefront(interpret=True)``) on
basic.toml (mg) and cornell_spheres.toml (sm), and against the port's own
blockwise route, bit for bit: one bounce function (csrc/trace.cuh, and
render._bounce_plain for the plain versions), so the sorts, the chunking
and the live-prefix limit change no frame."""

import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu.ops import pallas_wavefront as jwf
from rt_tpu_torch import renderer as treg
from rt_tpu_torch.ops import blockwise as tb
from rt_tpu_torch.ops import wavefront as twf
from test_torch_common import assert_frames_close
from test_torch_ops import jax_scene


@pytest.mark.parametrize("name,personality,seed", [
    ("basic.toml", "mg", 3),
    ("cornell_spheres.toml", "sm", 11),
])
def test_wavefront_frames_match_jax(name, personality, seed):
    js = jax_scene(name)
    size = (16, 12)
    kw = dict(spp=2, max_bounces=4, seed=seed, personality=personality)
    want = np.asarray(jwf.render_forward_wavefront(js, size, interpret=True, **kw))
    got = twf.render_forward_wavefront(rt_tpu_torch.from_jax_scene(js), size, device="cpu",
                                       **kw)
    assert got.shape == (12, 16, 3)
    assert_frames_close(got, want)


@pytest.mark.parametrize("name,personality,opts", [
    ("basic.toml", "mg", dict(spp=6, max_bounces=8, seed=5)),
    ("cornell_spheres.toml", "sm", dict(spp=3, max_bounces=6, seed=-2, rng_mode="sphere")),
    ("dielectric.toml", "sm", dict(spp=2, max_bounces=8, seed=9, gamma=False)),
    ("box", "mg", dict(spp=5, max_bounces=5, seed=1, include_boxes=True)),
    ("proc40", "mg", dict(spp=4, max_bounces=8, seed=4)),
])
def test_wavefront_frames_equal_blockwise(name, personality, opts):
    js = (rt_tpu.scene.make_procedural_scene(40) if name == "proc40" else jax_scene(name))
    ts = rt_tpu_torch.from_jax_scene(js)
    size = (20, 12)
    want = tb.render_forward_blockwise(ts, size, personality=personality, device="cpu", **opts)
    got = twf.render_forward_wavefront(ts, size, personality=personality, device="cpu", **opts)
    assert torch.equal(got, want)
    assert got.is_contiguous()


def test_schedule_knobs_leave_the_frame():
    """Sorting at every bounce, never, or shrinking at the first sort:
    the rays run in another order and the frame stays the same; a chunk of
    one sample renders another, equally valid, frame (other chunk seeds)."""
    ts = rt_tpu_torch.scene.make_procedural_scene(30)
    size, kw = (16, 10), dict(spp=3, max_bounces=7, seed=8, device="cpu")
    want = twf.render_forward_wavefront(ts, size, **kw)
    for sched, shrink, bits in (((1, 2, 3, 4, 5, 6), -1, 2), ((), None, 2), ((1, 4), 1, 3),
                                ((3,), 3, 1)):
        got = twf.render_forward_wavefront(ts, size, sort_schedule=sched, shrink_at=shrink,
                                           cell_bits=bits, **kw)
        assert torch.equal(got, want), (sched, shrink)
    other = twf.render_forward_wavefront(ts, size, spp_chunk=1, **kw)
    assert not torch.equal(other, want)
    assert torch.equal(other, twf.render_forward_wavefront(ts, size, spp_chunk=1, **kw))


def test_wavefront_renderers_and_cli(tmp_path):
    from rt_tpu_torch.cli import main

    ts = rt_tpu_torch.scene.make_procedural_scene(20)
    kw = dict(seed=2, spp=1, max_bounces=3, device="cpu")
    for pers in ("mg", "sm"):
        got = treg.create(f"{pers}_wavefront")(ts, (8, 6), **kw)
        assert torch.equal(got, tb.render_forward_blockwise(ts, (8, 6), personality=pers, **kw))
    out = tmp_path / "w.npy"
    assert main(["--procedural", "20", "--renderer", "sm_wavefront", "--size", "8x6", "--spp",
                 "1", "--bounces", "3", "--seed", "2", "--device", "cpu", "--out", str(out)]) == 0
    # the CLI's kernel renderers draw with seed 0 whatever --seed says, as JAX's
    np.testing.assert_array_equal(np.load(out), tb.render_forward_blockwise(
        ts, (8, 6), personality="sm", **{**kw, "seed": 0}).numpy())
