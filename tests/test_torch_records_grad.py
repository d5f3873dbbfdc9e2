"""``rt_tpu_torch.diff.records_loss_and_grad`` (the record pass, then
autograd through the replay) against ``rt_tpu.diff.pallas_loss_and_grad``
(``rng_impl="hash", interpret=True``) on the unrolled and the blockwise
record routes, against the port's own fused per-sample step at matched
draws, and against finite differences of its own loss."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu.ops import pallas_render as jr
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch.ops import blockwise as tb
from rt_tpu_torch.ops import grad as tg
from rt_tpu_torch.ops import render as tr
from test_torch_common import REPLAY_BOX_TOML
from test_torch_ops import jax_scene


def _params(js):
    jp = jdiff.extract_params(js)
    return jp, tdiff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def assert_grads_close(got, want):
    """The JAX package's tolerances between its fused and replay paths
    (tests/test_pallas.py): atol 2e-4 x each key's largest entry, rtol
    2e-3; every gradient finite."""
    assert set(got) == set(want)
    for k in want:
        a = np.asarray(want[k])
        g = got[k].detach().cpu().numpy()
        assert g.shape == a.shape and np.isfinite(g).all(), k
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(g, a, atol=2e-4 * scale, rtol=2e-3, err_msg=k)


def test_records_route_matches_jax_spp3():
    """basic.toml at spp 3: samples 1 and 2 reuse the second record call
    with their own seeds in JAX (tests/test_pallas.py:204-228)."""
    js = jax_scene("basic.toml")
    size, spp, bounces = (24, 16), 3, 2
    target = np.full((16, 24, 3), 0.25, np.float32)
    jp, tp = _params(js)
    kw = dict(seed=11, spp=spp, max_bounces=bounces)
    want_loss, want = jdiff.pallas_loss_and_grad(jp, js, jnp.asarray(target), size,
                                                 rng_impl="hash", interpret=True, **kw)
    loss, got = tdiff.records_loss_and_grad(tp, rt_tpu_torch.from_jax_scene(js), target, size,
                                            device="cpu", **kw)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert_grads_close(got, want)


def test_records_route_blockwise_boxes(monkeypatch):
    """Past the unrolled cap (monkeypatched down in both packages, as
    tests/test_pallas.py:241 does): both route the record pass to the
    blockwise record kernel, on a --boxes scene, and the box parameters get
    gradients."""
    monkeypatch.setattr(jr, "MAX_UNROLL_PRIMS", 2)
    monkeypatch.setattr(tr, "MAX_UNROLL_PRIMS", 2)
    calls = []
    real = tb.render_record_blockwise_tile
    monkeypatch.setattr(tb, "render_record_blockwise_tile",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    js = rt_tpu.loads(REPLAY_BOX_TOML)
    size = (16, 8)
    target = np.random.default_rng(2).uniform(0.0, 0.5, (8, 16, 3)).astype(np.float32)
    jp, tp = _params(js)
    kw = dict(seed=3, spp=2, max_bounces=3, include_boxes=True)
    want_loss, want = jdiff.pallas_loss_and_grad(jp, js, jnp.asarray(target), size,
                                                 rng_impl="hash", interpret=True, **kw)
    loss, got = tdiff.records_loss_and_grad(tp, rt_tpu_torch.from_jax_scene(js), target, size,
                                            device="cpu", **kw)
    assert len(calls) == 2
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert_grads_close(got, want)
    assert got["boxes.center"].abs().max() > 0 and got["boxes.extents"].abs().max() > 0


@pytest.mark.parametrize("name,personality", [("basic.toml", "mg"), ("dielectric.toml", "sm")])
def test_records_route_matches_fused_multi_step(name, personality):
    """At the same seed the records route and make_mse_step(mode="multi")
    trace the same paths with the same draws: the same loss and
    gradients (the per-sample kernel's hand adjoint against autograd
    through the replay)."""
    scene = rt_tpu_torch.from_jax_scene(jax_scene(name))
    size = (16, 12)
    target = np.random.default_rng(4).uniform(0.0, 0.5, (12, 16, 3)).astype(np.float32)
    params = tdiff.extract_params(scene)
    kw = dict(spp=2, max_bounces=4, personality=personality, device="cpu")
    l_r, g_r = tdiff.records_loss_and_grad(params, scene, target, size, seed=6, **kw)
    l_m, g_m = tg.mse_loss_and_grad(params, scene, target, size, seed=6, mode="multi", **kw)
    assert float(l_r) == pytest.approx(float(l_m), rel=1e-5)
    assert_grads_close(g_r, {k: v.numpy() for k, v in g_m.items()})


def test_records_route_at_a_moved_camera():
    """With ``camera.position`` moved away from the scene's camera, the
    record pass traces from the params' camera: at one seed the route
    gives the fused per-sample step's loss and gradients at that camera.
    (JAX's ``pallas_loss_and_grad`` records from ``scene.camera`` whatever
    the params say (rt_tpu/diff.py:315), so away from the scene's camera it
    replays paths recorded from another pose; it is no reference here.)"""
    scene = rt_tpu_torch.from_jax_scene(jax_scene("dielectric.toml"))
    size = (16, 12)
    target = np.random.default_rng(5).uniform(0.0, 0.5, (12, 16, 3)).astype(np.float32)
    params = dict(tdiff.extract_params(scene))
    params["camera.position"] = scene.camera.position + torch.tensor([0.05, -0.02, 0.03])
    kw = dict(spp=2, max_bounces=4, personality="sm", device="cpu")
    l_r, g_r = tdiff.records_loss_and_grad(params, scene, target, size, seed=9, **kw)
    l_m, g_m = tg.mse_loss_and_grad(params, scene, target, size, seed=9, mode="multi", **kw)
    l_0, _ = tdiff.records_loss_and_grad(tdiff.extract_params(scene), scene, target, size,
                                         seed=9, **kw)
    assert float(l_r) == pytest.approx(float(l_m), rel=1e-5)
    assert float(l_r) != pytest.approx(float(l_0), rel=1e-3)  # the move changes the frame
    assert_grads_close(g_r, {k: v.numpy() for k, v in g_m.items()})


def test_records_route_box_center_fd():
    """A central finite difference through the port's own loss on a box's
    centre (tests/test_replay.py:157-176), the camera-only parameter set,
    and the route's errors."""
    scene = rt_tpu_torch.loads(REPLAY_BOX_TOML)
    size = (24, 18)
    target = torch.zeros((18, 24, 3))
    params = tdiff.extract_params(scene)
    kw = dict(seed=2, spp=1, max_bounces=2, include_boxes=True, device="cpu")
    _, grads = tdiff.records_loss_and_grad(params, scene, target, size, **kw)
    eps = 1e-3
    losses = []
    for sign in (1, -1):
        p = dict(params)
        p["boxes.center"] = params["boxes.center"].clone()
        p["boxes.center"][0, 2] += sign * eps
        losses.append(float(tdiff.records_loss_and_grad(p, scene, target, size, **kw)[0]))
    fd = (losses[0] - losses[1]) / (2 * eps)
    an = float(grads["boxes.center"][0, 2])
    assert abs(an - fd) <= max(0.05 * abs(fd), 1e-5), (an, fd)

    cam_only = {"camera.position": scene.camera.position}
    loss, g = tdiff.records_loss_and_grad(cam_only, scene, target, size, **kw)
    assert set(g) == {"camera.position"} and g["camera.position"].abs().max() > 0

    big = rt_tpu_torch.scene.make_procedural_scene(tb.MAX_BLOCKWISE_PRIMS + 1)
    with pytest.raises(ValueError, match="every record-kernel limit"):
        tdiff.records_loss_and_grad(tdiff.extract_params(big), big, target, size, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdiff.records_loss_and_grad(params, scene, target, size)
