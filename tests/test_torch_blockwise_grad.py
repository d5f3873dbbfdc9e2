"""The blockwise fused step's plain PyTorch path against the JAX blockwise
pipeline (``bw_mse_loss_and_grad(rng_impl="hash", interpret=True)``) on
basic.toml and on a plane scene (the plane branch of the scan and of the
adjoint, and the plane material slots)."""

import pytest

from test_torch_grad_mono import assert_step_matches_jax


@pytest.mark.parametrize("name,seed", [("basic.toml", 3), ("planes", 9)])
def test_bw_step_matches_jax(name, seed):
    assert_step_matches_jax(name, "mg", "blockwise", spp=2, seed=seed)
