"""The replay and the host pieces it needs against the JAX package:
``materials.scatter``, ``ops.intersect.safe_normalize``,
``integrator.sky_colour``/``_pixel_grid``, and ``replay.replay_radiance``
with its autograd gradient against ``jax.grad`` of the JAX replay, on the
records and draws of the JAX record kernel (``render_record_pallas(
rng_impl="hash", interpret=True)``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu import integrator as jint
from rt_tpu import materials as jmat
from rt_tpu.camera import generate_rays as jrays
from rt_tpu.ops import intersect as jisect
from rt_tpu.ops import pallas_render as jr
from rt_tpu.replay import PathRecords as JRec
from rt_tpu.replay import replay_radiance as jreplay
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch import integrator as tint
from rt_tpu_torch import materials as tmat
from rt_tpu_torch import replay as trep
from rt_tpu_torch.ops import intersect as tisect
from rt_tpu_torch.ops import render as tr
from rt_tpu_torch.ops import tables as tt
from test_torch_common import REPLAY_BOX_TOML, tiles_to_flat
from test_torch_ops import jax_scene


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("personality", ["mg", "sm"])
@pytest.mark.parametrize("pinned", [False, True])
def test_scatter_matches_jax(personality, pinned):
    """Seeded random hits on dielectric.toml's materials (lambert, metal and
    dielectric under sm): every class, inside and outside hits, degenerate
    lambert lanes, with and without pinned decisions."""
    js = jax_scene("dielectric.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    rng = np.random.default_rng(1 if pinned else 0)
    n = 2048
    mat = rng.integers(0, js.materials.count, n).astype(np.int32)
    d, nrm, ur = _unit(rng, n), _unit(rng, n), _unit(rng, n)
    ur[:16] = -nrm[:16]  # normal + unit vector = 0: the degenerate lambert
    coin = rng.uniform(size=n).astype(np.float32)
    dec = (rng.uniform(size=n) < 0.5, rng.uniform(size=n) < 0.1) if pinned else None
    jcls = jmat.personality_classes(personality)[js.materials.type[mat]]
    want = jmat.scatter(js.materials, jcls, jnp.asarray(mat), jnp.asarray(d), jnp.asarray(nrm),
                        jnp.asarray(ur), jnp.asarray(coin),
                        decisions=None if dec is None else tuple(map(jnp.asarray, dec)))
    tcls = tmat.personality_classes(personality)[ts.materials.type[torch.from_numpy(mat).long()]
                                                  .long()]
    got = tmat.scatter(ts.materials, tcls, torch.from_numpy(mat), torch.from_numpy(d),
                       torch.from_numpy(nrm), torch.from_numpy(ur), torch.from_numpy(coin),
                       decisions=None if dec is None else tuple(map(torch.from_numpy, dec)))
    for k in ("direction", "attenuation"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    for k in ("absorbed", "reflect_bit", "lam_deg"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.lam_deg[:16].all() or pinned
    assert got.absorbed.any() and got.reflect_bit.any()


def test_safe_normalize_zero_vector():
    """A zero vector: the fallback (default zero), and a finite gradient."""
    v = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 4.0], [1e-12, 0.0, 0.0]], requires_grad=True)
    fb = torch.tensor([[0.0, 1.0, 0.0]] * 3)
    out = tisect.safe_normalize(v, fallback=fb)
    assert torch.equal(out[0], fb[0]) and torch.equal(out[2], fb[2])
    np.testing.assert_allclose(out[1].detach().numpy(), [0.6, 0.0, 0.8], rtol=1e-6)
    assert torch.equal(tisect.safe_normalize(v)[0].detach(), torch.zeros(3))
    (g,) = torch.autograd.grad(tisect.safe_normalize(v).sum(), v)
    assert torch.isfinite(g).all() and torch.equal(g[0], torch.zeros(3))
    want = np.asarray(jax.grad(lambda x: jisect.safe_normalize(x).sum())(
        jnp.asarray(v.detach().numpy())))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-7)
    assert tisect.MIN_HIT_DIST == jisect.MIN_HIT_DIST


def test_sky_colour_and_pixel_grid():
    d = torch.from_numpy(_unit(np.random.default_rng(3), 64))
    np.testing.assert_allclose(tint.sky_colour(d).numpy(),
                               np.asarray(jint.sky_colour(jnp.asarray(d.numpy()))), atol=1e-7)
    np.testing.assert_array_equal(tint._pixel_grid((7, 5)).numpy(),
                                  np.asarray(jint._pixel_grid((7, 5))))


SIZE, BOUNCES = (16, 12), 3
CASES = {  # id: scene, personality, --boxes
    "basic/mg": ("basic.toml", "mg", False),
    "dielectric/sm": ("dielectric.toml", "sm", False),
    "box scene/mg": ("replay-box", "mg", True),
}


def _jax_scene(name):
    return rt_tpu.loads(REPLAY_BOX_TOML) if name == "replay-box" else jax_scene(name)


@pytest.mark.parametrize("cid", list(CASES))
def test_replay_matches_jax(cid):
    """The replay's value within 1e-5 of JAX's on the JAX record kernel's
    records and draws (dead lanes included, as JAX writes them), and the
    autograd gradient of an MSE over it against jax.grad for every key,
    camera and boxes included."""
    name, pers, boxes = CASES[cid]
    js = _jax_scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    w, h = SIZE
    n = w * h
    _, jrecs = jr.render_record_pallas(js, SIZE, 7, personality=pers, max_bounces=BOUNCES,
                                       rows=8, center_sample=False, rng_impl="hash",
                                       interpret=True, include_boxes=boxes)
    jflat = jr.records_to_flat(jrecs, n, BOUNCES)
    raw = {k: torch.from_numpy(tiles_to_flat(v, n).copy()) for k, v in jrecs.items()}
    for k in ("kind", "idx", "bits"):
        raw[k] = raw[k].to(torch.int32)
    tflat = tr.records_to_flat(raw)
    target = np.random.default_rng(5).uniform(0.0, 0.5, (h, w, 3)).astype(np.float32)
    grid_j = jint._pixel_grid(SIZE)

    # the value
    o, d = jrays(js.camera, SIZE, grid_j + jflat["jitter"])
    names = ("kind", "idx", "root_lo", "live_in", "miss", "alive_out", "reflect_bit", "lam_deg")
    want_rad = np.asarray(jreplay(js, o, d, None, JRec(*(jflat[k] for k in names)),
                                  personality=pers, max_bounces=BOUNCES,
                                  draws=(jflat["ur"], jflat["coin"]), include_boxes=boxes))
    to, td = rt_tpu_torch.camera.generate_rays(ts.camera, SIZE,
                                               tint._pixel_grid(SIZE) + tflat["jitter"])
    got_rad = trep.replay_radiance(ts, to, td, None, trep.PathRecords(*(tflat[k] for k in names)),
                                   personality=pers, max_bounces=BOUNCES,
                                   draws=(tflat["ur"], tflat["coin"]), include_boxes=boxes)
    np.testing.assert_allclose(got_rad.numpy(), want_rad, rtol=0, atol=1e-5)
    assert np.abs(want_rad).max() > 0.1

    # the gradient
    jp = jdiff.extract_params(js)
    want_loss, want = jdiff._replay_value_and_grad(
        jp, js, jnp.asarray(target), [jflat], size=SIZE, personality=pers,
        max_bounces=BOUNCES, include_boxes=boxes, grid=grid_j)
    tp = tdiff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    loss, got = tdiff._replay_value_and_grad(
        tp, ts, torch.from_numpy(target), tflat, spp=1, size=SIZE, personality=pers,
        max_bounces=BOUNCES, include_boxes=boxes, grid=tint._pixel_grid(SIZE))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert set(got) == set(want) == set(tp)
    for k in want:
        a = np.asarray(want[k])
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(g, a, atol=2e-4 * scale, rtol=2e-3, err_msg=k)
    if boxes:
        assert np.abs(got["boxes.center"].numpy()).max() > 0


def test_replay_unported_options_raise():
    """``draws=None``, which raised before the threefry rng was ported,
    regenerates the draws from the key (the same radiance as the draws
    passed in); ``prims_axis``, which raised before dist was ported, on an
    axis of one rank is the unsharded replay (tests/test_torch_dist.py
    holds the sharded one)."""
    from rt_tpu_torch import rng as trng

    ts = rt_tpu_torch.loads(REPLAY_BOX_TOML)
    z = torch.zeros((1, 4), dtype=torch.int32)
    recs = trep.PathRecords(z, z, *(z.bool(),) * 6)
    o = torch.zeros((4, 3))
    key = trng.make_key(3)
    got = trep.replay_radiance(ts, o, o, key, recs, max_bounces=1)
    want = trep.replay_radiance(ts, o, o, None, recs, max_bounces=1,
                                draws=tint._draws(key, 1, 4, "reference", "cpu"))
    assert got.shape == (4, 3) and torch.equal(got, want)

    class OneRank:  # a mesh axis of one rank (dist.MeshAxis's collectives)
        rank, size = 0, 1

        def psum(self, x):
            return x

        all_sum = psum

    assert torch.equal(trep.replay_radiance(ts, o, o, key, recs, max_bounces=1,
                                            prims_axis=OneRank()), got)


@pytest.mark.parametrize("name,personality,boxes", [("basic.toml", "mg", False),
                                                    ("dielectric.toml", "sm", False),
                                                    ("replay-box", "mg", True)])
def test_replay_retraces_the_record_kernel(name, personality, boxes):
    """The replay's rays are the record kernel's to the bit
    (``diff._record_rays`` against ``render._raygen_plain``), and the replay
    of the port's own records gives the record radiance (the sky term is
    written another way, so within float rounding)."""
    ts = rt_tpu_torch.from_jax_scene(_jax_scene(name))
    size, depth = (24, 16), 4
    rad, raw = tr.render_record(ts, size, 3, personality=personality, max_bounces=depth,
                                center_sample=False, include_boxes=boxes, device="cpu")
    flat = tr.records_to_flat(raw)
    grid = tint._pixel_grid(size)
    o, d = tdiff._record_rays(ts.camera, size, grid, flat["jitter"])
    ro, rd = tr._raygen_plain(torch.from_numpy(tt._pack_camera(ts.camera, size)).tolist(),
                              grid[:, 0], grid[:, 1], flat["jitter"][:, 0], flat["jitter"][:, 1],
                              *tr._inv_size(*size))
    assert torch.equal(o, torch.stack(ro, dim=-1)) and torch.equal(d, torch.stack(rd, dim=-1))
    names = ("kind", "idx", "root_lo", "live_in", "miss", "alive_out", "reflect_bit", "lam_deg")
    got = trep.replay_radiance(ts, o, d, None, trep.PathRecords(*(flat[k] for k in names)),
                               personality=personality, max_bounces=depth,
                               draws=(flat["ur"], flat["coin"]), include_boxes=boxes)
    np.testing.assert_allclose(got.numpy(), rad.reshape(-1, 3).numpy(), rtol=0, atol=1e-6)
