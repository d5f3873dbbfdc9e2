"""The wavefront fused step's plain PyTorch path: against the JAX wavefront
pipeline (``make_wf_mse_step(interpret=True)``) on basic.toml over two
sample chunks, and against the port's own blockwise step at matched draws
on sm scenes with planes and dielectrics (the JAX package never tested
its wavefront sm reverse; VERDICT weak 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu.ops import pallas_wavefront_grad as jwg
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch.ops import blockwise_grad as tbg
from rt_tpu_torch.ops import wavefront as twf
from rt_tpu_torch.ops import wavefront_grad as twg
from test_torch_ops import jax_scene


def _assert_grads_close(got, want, atol_rel=2e-4, rtol=2e-3):
    """Each gradient to atol 2e-4 x its largest entry and rtol 2e-3: the
    JAX package's own tolerances between its gradient pipelines."""
    assert set(got) == set(want)
    for k in want:
        a = np.asarray(want[k])
        assert got[k].shape == a.shape, k
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), a, atol=atol_rel * scale, rtol=rtol, err_msg=k)


def test_wf_step_matches_jax():
    js = jax_scene("basic.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    size = (12, 8)
    target = np.random.default_rng(0).uniform(0.0, 0.5, (8, 12, 3)).astype(np.float32)
    jp = jdiff.extract_params(js)
    tp = tdiff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    kw = dict(spp=5, max_bounces=3)   # two chunks (4 + 1 samples), two chunk seeds
    want_loss, want = jwg.make_wf_mse_step(jp, js, jnp.asarray(target), size, interpret=True,
                                           **kw)(13)
    loss, got = twg.make_wf_mse_step(tp, ts, target, size, device="cpu", **kw)(13)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    _assert_grads_close(got, want)
    # the record pass is the frame: the loss is the wavefront frame's MSE
    frame = twf.render_forward_wavefront(ts, size, seed=13, gamma=False, device="cpu", **kw)
    assert float(loss) == float(((frame - torch.from_numpy(target)) ** 2).mean())


@pytest.mark.parametrize("name,personality,seed", [
    ("cornell_spheres.toml", "sm", 3),
    ("dielectric.toml", "sm", 8),
    ("planes", "mg", 5),
])
def test_wf_step_matches_blockwise_at_matched_draws(name, personality, seed):
    """At 1 spp the wavefront step at seed S * 100003 draws what the
    blockwise step at seed S draws (its sample seeds are S * 100003 + s):
    the same frame, so the same loss, and gradients within 2e-4 x max|g|
    (the tolerance of rt_tpu's tests/test_pallas_wavefront_grad.py)."""
    ts = rt_tpu_torch.from_jax_scene(jax_scene(name))
    size = (16, 12)
    target = np.random.default_rng(seed).uniform(0.0, 0.5, (12, 16, 3)).astype(np.float32)
    params = tdiff.extract_params(ts)
    kw = dict(spp=1, max_bounces=6, personality=personality, device="cpu")
    lw, gw = twg.wf_mse_loss_and_grad(params, ts, target, size, seed=seed * 100003, **kw)
    lb, gb = tbg.bw_mse_loss_and_grad(params, ts, target, size, seed=seed, **kw)
    assert float(lw) == float(lb)
    for k in gb:
        scale = max(float(gb[k].abs().max()), 1e-30)
        assert float((gw[k] - gb[k]).abs().max()) <= 2e-4 * scale, k
    assert any(float(g.abs().max()) > 0 for g in gw.values())
