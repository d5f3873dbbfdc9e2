"""rt_tpu_torch.ops.intersect.closest_hit against rt_tpu.ops.intersect's on
10^4 seeded random rays (half of them aimed at primitives): the winners
(kind, idx, root_lo, material, hit) equal on every ray, t and the normal
within 2 ulp (measured: t equal to the bit, the normal within 2 ulp)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu.ops import intersect as jisect
from rt_tpu_torch.ops import intersect as tisect
from test_torch_common import SCENES, tie_scene_toml

TWO_BOXES = ("\nboxes = [ { material = 2, position = [-1, 0.5, 0.3], extents = [0.3, 0.5, 0.3] },\n"
             "          { material = 1, position = [1.2, 0.3, -0.5], extents = [0.4, 0.3, 0.2] } ]\n")
N_RAYS = 10_000


def _scene(name):
    if name == "basic+2box":
        return rt_tpu.loads((SCENES / "basic.toml").read_text() + TWO_BOXES)
    if name == "ties":
        return rt_tpu.loads(tie_scene_toml())
    return rt_tpu.load(str(SCENES / name))


def _rays(js, seed):
    """Origins scattered around the camera; half the directions random,
    half aimed at a random point of a random sphere or box."""
    rng = np.random.default_rng(seed)
    o = np.asarray(js.camera.position) + rng.normal(size=(N_RAYS, 3)) * 1.5
    d = rng.normal(size=(N_RAYS, 3))
    d[:, 2] -= 1.0
    s_c = np.asarray(js.spheres.center)[:js.spheres.count]
    s_r = np.asarray(js.spheres.radius)[:js.spheres.count]
    aims = [s_c + rng.uniform(-1, 1, s_c.shape) * s_r[:, None]]
    if js.boxes.count:
        b_c = np.asarray(js.boxes.center)[:js.boxes.count]
        aims.append(b_c + rng.uniform(-1, 1, b_c.shape) * np.asarray(js.boxes.extents)[:js.boxes.count])
    targets = np.concatenate(aims)
    half = N_RAYS // 2
    d[half:] = targets[rng.integers(0, len(targets), N_RAYS - half)] - o[half:]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _ulps(a, b):
    """Distance in float32 ulps (signed zeros equal)."""
    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(np.ascontiguousarray(a)) - key(np.ascontiguousarray(b)))


@pytest.mark.parametrize("name", ["basic.toml", "cornell_spheres.toml", "basic+2box", "ties"])
@pytest.mark.parametrize("opts", [
    {},
    {"include_boxes": True},
    {"tie_order": "rasterizer"},
    {"include_boxes": True, "box_normals_up": True, "tie_order": "rasterizer"},
], ids=["tracer", "tracer-boxes", "rasterizer-noboxes", "rasterizer"])
def test_closest_hit_matches_jax(name, opts):
    js = _scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    o, d = _rays(js, seed=len(name))
    want = jisect.closest_hit(js.spheres, js.planes, js.boxes, jnp.asarray(o), jnp.asarray(d),
                              **opts)
    got = tisect.closest_hit(ts.spheres, ts.planes, ts.boxes, torch.from_numpy(o),
                             torch.from_numpy(d), **opts)
    for k in ("kind", "idx", "root_lo", "material", "hit"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.t.dtype == torch.float32 and got.normal.dtype == torch.float32
    assert _ulps(got.t.numpy(), np.asarray(want.t)).max() <= 2
    assert _ulps(got.normal.numpy(), np.asarray(want.normal)).max() <= 2
    kinds = set(np.unique(got.kind.numpy()))
    assert {0, 1} <= kinds
    if name == "cornell_spheres.toml":
        assert 2 in kinds
    if js.boxes.count and opts.get("include_boxes"):
        assert 3 in kinds
    if name == "ties":
        # rows 2k and 2k+1 (k < 12) and 24 + k are one sphere: the first
        # copy wins every tie
        won = got.idx.numpy()[got.kind.numpy() == 1]
        assert not np.isin(won, list(range(1, 24, 2)) + list(range(24, 36))).any()
        assert np.isin(won, range(0, 24, 2)).any()


def test_closest_hit_gradients_finite():
    """Autograd through the closest hit's t and normal reaches the sphere
    and box tables with finite values, misses and boxes included."""
    js = _scene("basic+2box")
    ts = rt_tpu_torch.from_jax_scene(js)
    o, d = _rays(js, seed=3)
    c = ts.spheres.center.clone().requires_grad_(True)
    r = ts.spheres.radius.clone().requires_grad_(True)
    bc = ts.boxes.center.clone().requires_grad_(True)
    be = ts.boxes.extents.clone().requires_grad_(True)
    sph = dataclasses.replace(ts.spheres, center=c, radius=r)
    box = dataclasses.replace(ts.boxes, center=bc, extents=be)
    rec = tisect.closest_hit(sph, ts.planes, box, torch.from_numpy(o), torch.from_numpy(d),
                             include_boxes=True)
    (torch.where(rec.hit, rec.t, 0.0).sum() + rec.normal.sum()).backward()
    for g in (c.grad, r.grad, bc.grad, be.grad):
        assert torch.isfinite(g).all() and g.abs().sum() > 0
