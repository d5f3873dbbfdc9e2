"""The mono step's plain PyTorch version against the JAX mono kernel
(``pallas_mse_loss_and_grad(mode="mono", rng_impl="hash",
interpret=True)``) on basic.toml and on a plane scene."""

import jax.numpy as jnp
import numpy as np
import pytest

import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu.ops import pallas_blockwise_grad as jbg
from rt_tpu.ops import pallas_grad as jpg
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch.ops import blockwise_grad as tbg
from rt_tpu_torch.ops import grad as tg
from test_torch_ops import jax_scene


def assert_step_matches_jax(name, personality, mode, size=(16, 8), spp=2, max_bounces=3, seed=3):
    """Both packages take one fused step at the same params, scene tables,
    target and seed: ``make_mse_step`` with ``mode`` ("mono" or "multi"),
    or for ``mode="blockwise"`` the blockwise step (``bw_mse_loss_and_grad``).
    Tolerances: the loss to rel 1e-5, each gradient to atol 2e-4 x its
    largest entry and rtol 2e-3 -- the JAX package's own tolerances between
    its fused and replay paths (tests/test_pallas.py)."""
    js = jax_scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    w, h = size
    target = np.random.default_rng(0).uniform(0.0, 0.5, (h, w, 3)).astype(np.float32)
    jp = jdiff.extract_params(js)
    tp = tdiff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    kw = dict(seed=seed, spp=spp, max_bounces=max_bounces, personality=personality)
    if mode == "blockwise":
        want_loss, want = jbg.bw_mse_loss_and_grad(jp, js, jnp.asarray(target), size,
                                                   rng_impl="hash", interpret=True, **kw)
        loss, got = tbg.bw_mse_loss_and_grad(tp, ts, target, size, device="cpu", **kw)
    else:
        want_loss, want = jpg.pallas_mse_loss_and_grad(
            jp, js, jnp.asarray(target), size, rows=8, rng_impl="hash", interpret=True,
            mode=mode, **kw)
        seed = kw.pop("seed")
        step = tg.make_mse_step(tp, ts, target, size, mode=mode, device="cpu", **kw)
        assert step.mode == mode
        loss, got = step(seed)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert set(got) == set(want)
    for k in want:
        a = np.asarray(want[k])
        assert got[k].shape == a.shape, k
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), a, atol=2e-4 * scale, rtol=2e-3, err_msg=k)
        assert np.abs(a).max() > 0 or k.startswith("boxes"), k


def test_mono_basic_mg():
    assert_step_matches_jax("basic.toml", "mg", "mono")


def test_mono_planes():
    # a plane winner: the plane branch of the hand adjoint and its material slots
    assert_step_matches_jax("planes", "mg", "mono", seed=9)
