"""The per-sample route (render kernel frames, torch loss and cotangent,
one gradient kernel per sample) against the JAX per-sample pipeline
(``mode="multi"``) on dielectric.toml with the sm personality: the
Fresnel/refraction adjoint, and per-sample seeds that wrap in int32."""

from test_torch_grad_mono import assert_step_matches_jax


def test_multi_dielectric_sm():
    # seed0 * 100003 overflows int32 past 21474
    assert_step_matches_jax("dielectric.toml", "sm", "multi", seed=30011)
