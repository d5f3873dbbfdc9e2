"""rt_tpu_torch.integrator against rt_tpu.integrator on the CPU: trace_batch
and render_image (the jnp-style path tracer, with the threefry draws of
rt_tpu_torch.rng), the rasterizer and the null renderer; and trace_batch
against the recursive NumPy mirror tests/ref_impl.py fed the same draws.
Frames agree within ATOL on all but MAX_SHARE of their pixels
(test_torch_common: XLA's CPU backend contracts FMAs, so a ray that grazes
a silhouette can take the other branch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ref_impl
import rt_tpu
import rt_tpu_torch
from rt_tpu import integrator as jint
from rt_tpu import rng as jrng
from rt_tpu_torch import integrator as tint
from rt_tpu_torch import rng as trng
from test_torch_common import BOX_TOML, SCENES, assert_frames_close


def _scene(name):
    if name == "basic+box":
        return rt_tpu.loads((SCENES / "basic.toml").read_text() + BOX_TOML)
    return rt_tpu.load(str(SCENES / name))


# (scene, personality, include_boxes, rng_mode, ray_chunk, chunk_offset): 32x24 is
# 768 pixels, so chunks of 500 and 300 leave a padded last chunk, None clamps
# to one chunk of 1024
CASES = [
    ("basic.toml", "mg", False, "reference", 500, 0),
    ("cornell_spheres.toml", "sm", False, "reference", 256, 3),
    ("dielectric.toml", "sm", False, "reference", None, 0),
    ("basic+box", "mg", True, "reference", 300, 1),
    ("cornell_spheres.toml", "sm", False, "sphere", 512, 2),
]


@pytest.mark.parametrize("name,personality,include_boxes,rng_mode,ray_chunk,chunk_offset", CASES)
def test_render_image_matches_jax(name, personality, include_boxes, rng_mode, ray_chunk,
                                  chunk_offset):
    js = _scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    kw = dict(spp=2, max_bounces=4, personality=personality, include_boxes=include_boxes,
              rng_mode=rng_mode, ray_chunk=ray_chunk, chunk_offset=chunk_offset)
    want = jint.render_image(js, (32, 24), jrng.make_key(11), **kw)
    got = tint.render_image(ts, (32, 24), trng.make_key(11), device="cpu", **kw)
    assert got.shape == (24, 32, 3)
    assert_frames_close(got, want)
    # the chunking is folded into the key: another chunk offset, another frame
    other = tint.render_image(ts, (32, 24), trng.make_key(11), device="cpu",
                              **{**kw, "chunk_offset": chunk_offset + 1})
    assert not torch.equal(other, got)


@pytest.mark.parametrize("name,personality", [("basic.toml", "mg"), ("dielectric.toml", "sm")])
def test_trace_batch_matches_jax(name, personality):
    js = _scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    pix = np.random.default_rng(5).uniform(0, 24, size=(600, 2)).astype(np.float32)
    jo, jd = rt_tpu.camera.generate_rays(js.camera, (32, 24), jnp.asarray(pix))
    want = jint.trace_batch(js, jo, jd, jrng.make_key(4), personality=personality,
                            max_bounces=4)
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    got = tint.trace_batch(ts, o, d, trng.make_key(4), personality=personality, max_bounces=4)
    assert_frames_close(got, want)


@pytest.mark.parametrize("name", ["basic+box", "cornell_spheres.toml"])
@pytest.mark.parametrize("compat", [True, False])
def test_rasterizer_and_null_match_jax(name, compat):
    js = _scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    want = jint.render_rasterizer(js, (32, 24), compat_colours=compat)
    got = tint.render_rasterizer(ts, (32, 24), compat_colours=compat, device="cpu")
    assert_frames_close(got, want)
    null = tint.render_null(ts, (32, 24), device="cpu")
    assert torch.equal(null, torch.from_numpy(np.asarray(jint.render_null(js, (32, 24)))))


def _mirror_rng(key, n, depth):
    """trace_batch's per-bounce draws, for ref_impl.trace_np."""
    ur, coin = tint._draws(key, depth, n, "reference", "cpu")

    def draws(bounce):
        return ur[bounce].numpy(), coin[bounce].numpy()
    return draws


@pytest.mark.parametrize("personality,table,name", [
    ("mg", ref_impl.MG_TABLE, "basic.toml"),
    ("sm", ref_impl.SM_TABLE, "basic.toml"),
    ("sm", ref_impl.SM_TABLE, "dielectric.toml"),
])
def test_trace_matches_mirror(personality, table, name):
    """tests/test_integrator.py's mirror check, on the port: the recursive
    NumPy trace fed the port's own draws."""
    ts = rt_tpu_torch.load(str(SCENES / name))
    snp = ref_impl.scene_to_np(ts)
    cam = ref_impl.camera_to_np(ts)
    w, h = 24, 16
    idx = np.arange(w * h)
    grid = np.stack([idx % w, idx // w], axis=-1).astype(np.float32) + 0.5
    o, d = ref_impl.generate_rays(cam["pos"], cam["rot"], cam["vfov"], cam["near"], (w, h), grid)
    key = trng.fold(trng.make_key(7), 99)
    rad = tint.trace_batch(ts, torch.from_numpy(o), torch.from_numpy(d), key,
                           personality=personality, max_bounces=5)
    want = ref_impl.trace_np(snp, o, d, 5, 0, _mirror_rng(key, w * h, 5), table)
    np.testing.assert_allclose(rad.numpy(), want, atol=2e-4, rtol=1e-3)


def test_sky_only_frame_and_default_chunk():
    ts = rt_tpu_torch.loads("camera = { position = 'origin', direction = 'up' }\n")
    img = tint.render_image(ts, (8, 8), trng.make_key(0), spp=2, max_bounces=3, device="cpu")
    np.testing.assert_allclose(img[4, 4].numpy(), np.sqrt([0.5, 0.7, 1.0]), atol=5e-3)
    for n in (1, 500, 17000):
        s = rt_tpu_torch.scene.make_procedural_scene(n)
        assert tint.default_ray_chunk(s) == jint.default_ray_chunk(rt_tpu.scene
                                                                   .make_procedural_scene(n))
    with pytest.raises(ValueError, match="grad_mode"):
        tint.render_image(ts, (4, 4), trng.make_key(0), spp=1, grad_mode="fd", device="cpu")
    with pytest.raises(NotImplementedError, match="dist"):
        tint.render_pixels(ts, (4, 4), tint._pixel_grid((4, 4)), trng.make_key(0), spp=1,
                           replay_prims_axis="prims")
