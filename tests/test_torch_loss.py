"""rt_tpu_torch's jnp-path gradients against rt_tpu's on the CPU:
replay.trace_batch_recorded's records against JAX's, diff.loss_and_grad
against rt_tpu.diff.loss_and_grad in both grad modes (tests/test_replay.py's
tolerances: the loss to rel 1e-5, every gradient within 3e-4 x max|g| and
rtol 3e-3), and the port's replay against its own autodiff."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu import replay as jrep
from rt_tpu import rng as jrng
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch import replay as trep
from rt_tpu_torch import rng as trng
from test_torch_common import REPLAY_BOX_TOML, SCENES, assert_frames_close

SIZE = (24, 16)
OPTS = dict(spp=2, max_bounces=3)


def _target(seed):
    return np.random.default_rng(seed).uniform(0.0, 0.6, (SIZE[1], SIZE[0], 3)).astype(np.float32)


def assert_grads_close(got, want):
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, rtol=3e-3, atol=3e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=k)


@pytest.fixture(scope="module", params=[("basic.toml", "mg"), ("dielectric.toml", "sm")],
                ids=["basic-mg", "dielectric-sm"])
def case(request):
    """The scene in both packages, a target, and the JAX package's loss and
    gradients in both grad modes (computed once per scene)."""
    name, personality = request.param
    js = rt_tpu.load(str(SCENES / name))
    target = _target(len(name))
    jp = jdiff.extract_params(js)
    want = {mode: jdiff.loss_and_grad(jp, js, jnp.asarray(target), SIZE, jrng.make_key(2),
                                      personality=personality, grad_mode=mode, **OPTS)
            for mode in ("replay", "autodiff")}
    return js, personality, target, want


@pytest.mark.parametrize("mode", ["replay", "autodiff"])
def test_loss_and_grad_matches_jax(case, mode):
    js, personality, target, want = case
    ts = rt_tpu_torch.from_jax_scene(js)
    tp = tdiff.params_from_numpy({k: np.asarray(v) for k, v in jdiff.extract_params(js).items()},
                                 device="cpu")
    loss, grads = tdiff.loss_and_grad(tp, ts, target, SIZE, trng.make_key(2),
                                      personality=personality, grad_mode=mode, device="cpu",
                                      **OPTS)
    w_loss, w_grads = want[mode]
    assert float(loss) == pytest.approx(float(w_loss), rel=1e-5)
    assert set(grads) == set(w_grads)
    assert_grads_close(grads, w_grads)
    assert grads["materials.albedo"].abs().max() > 0


def test_replay_matches_own_autodiff(case):
    js, personality, target, _ = case
    ts = rt_tpu_torch.from_jax_scene(js)
    tp = tdiff.extract_params(ts)
    kw = dict(personality=personality, device="cpu", **OPTS)
    loss_r, g_r = tdiff.loss_and_grad(tp, ts, target, SIZE, trng.make_key(6), grad_mode="replay",
                                      **kw)
    loss_a, g_a = tdiff.loss_and_grad(tp, ts, target, SIZE, trng.make_key(6),
                                      grad_mode="autodiff", **kw)
    assert float(loss_r) == pytest.approx(float(loss_a), rel=1e-6)
    assert_grads_close(g_r, {k: v.numpy() for k, v in g_a.items()})


@pytest.mark.parametrize("name,personality,include_boxes", [
    ("basic.toml", "mg", False), ("dielectric.toml", "sm", False),
    ("box", "mg", True)])
def test_recorded_trace_matches_jax(name, personality, include_boxes):
    """The records of one trace, field by field, equal to the JAX package's
    (on every ray); the radiance within the frames' tolerance of JAX's, and
    the draw-regenerating replay (``replay_radiance(draws=None)``) within
    1e-5 of the trace's."""
    if name == "box":
        js = rt_tpu.loads(REPLAY_BOX_TOML)
    else:
        js = rt_tpu.load(str(SCENES / name))
    ts = rt_tpu_torch.from_jax_scene(js)
    pix = np.random.default_rng(8).uniform(0, 16, size=(500, 2)).astype(np.float32)
    jo, jd = rt_tpu.camera.generate_rays(js.camera, SIZE, jnp.asarray(pix))
    j_rad, j_rec = jrep.trace_batch_recorded(js, jo, jd, jrng.make_key(9), personality=personality,
                                             max_bounces=4, include_boxes=include_boxes)
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    key = trng.make_key(9)
    rad, rec = trep.trace_batch_recorded(ts, o, d, key, personality=personality, max_bounces=4,
                                         include_boxes=include_boxes)
    for k in trep.PathRecords._fields:
        got, want = getattr(rec, k).numpy(), np.asarray(getattr(j_rec, k))
        assert got.shape == want.shape == (4, 500), k
        np.testing.assert_array_equal(got, want, err_msg=k)
    if include_boxes:
        assert (rec.kind.numpy() == 3).any()
    assert_frames_close(rad, j_rad)
    replayed = trep.replay_radiance(ts, o, d, key, rec, personality=personality, max_bounces=4,
                                    include_boxes=include_boxes)
    np.testing.assert_allclose(replayed.numpy(), rad.numpy(), rtol=1e-5, atol=2e-5)
