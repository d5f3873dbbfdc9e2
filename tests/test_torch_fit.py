"""rt_tpu_torch.train.fit against rt_tpu.train.fit on the CPU (three Adam
steps on examples/inverse_rendering.py's scene, albedo only), and a run
checkpointed every 2 steps and resumed, against the uninterrupted run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu import train as jtrain
from rt_tpu_torch import train as ttrain

# examples/inverse_rendering.py's scene
SCENE = """
    materials = [
        { type = 'lambert', albedo = [0.85, 0.85, 0.85] },
        { type = 'lambert', albedo = [0.2, 0.45, 0.85] },
        { type = 'metal',   albedo = [0.9, 0.9, 0.9], roughness = 0.1 },
    ]
    spheres = [
        { material = 0, position = [0, -1000, 0], radius = 1000 },
        { material = 1, position = [-0.7, 0.5, 0] },
        { material = 2, position = [0.7, 0.5, 0] },
    ]
    camera = { position = [0, 1, 3], direction = 'forward' }
"""
SIZE = (24, 16)
OPTS = dict(spp=4, max_bounces=4)


@pytest.fixture(scope="module")
def setup():
    """The example's set-up: the target at the true albedo (rendered by the
    JAX package), the scene with sphere 1's albedo corrupted."""
    js = rt_tpu.loads(SCENE)
    true = jdiff.extract_params(js)
    target = np.asarray(jdiff.render_for_loss(true, js, SIZE, rt_tpu.rng.make_key(0), **OPTS))
    start = dict(true)
    start["materials.albedo"] = true["materials.albedo"].at[1].set(jnp.asarray([0.8, 0.8, 0.2, 1.0]))
    return jdiff.apply_params(js, start), target


def test_three_fit_steps_match_jax(setup):
    js, target = setup
    kw = dict(steps=3, learning_rate=3e-2, param_names=["materials.albedo"], verbose=False, **OPTS)
    j_params, j_losses = jtrain.fit(js, jnp.asarray(target), SIZE, **kw)
    t_params, t_losses = ttrain.fit(rt_tpu_torch.from_jax_scene(js), target, SIZE, device="cpu",
                                    **kw)
    assert list(t_params) == ["materials.albedo"]
    assert t_losses == pytest.approx(j_losses, rel=1e-4)
    # Adam moves each entry by about lr = 3e-2 a step whatever the gradient's
    # scale (tolerance as in test_torch_blockwise_train.py)
    np.testing.assert_allclose(t_params["materials.albedo"].numpy(),
                               np.asarray(j_params["materials.albedo"]), rtol=1e-6, atol=3e-4)
    assert t_losses[-1] < t_losses[0]


def _opt_state(path, step):
    return torch.load(path / f"step_{step}.pt", weights_only=True)


def test_resume_equals_uninterrupted_run(setup, tmp_path, capsys):
    js, target = setup
    ts = rt_tpu_torch.from_jax_scene(js)
    kw = dict(learning_rate=3e-2, param_names=["materials.albedo", "spheres.center"],
              checkpoint_every=2, device="cpu", log_every=1, **OPTS)
    full, cut = tmp_path / "full", tmp_path / "cut"
    assert ttrain.restore_checkpoint(str(tmp_path), {}) is None
    p_full, l_full = ttrain.fit(ts, target, SIZE, steps=4, checkpoint_dir=str(full), **kw)
    assert "step    3" in capsys.readouterr().out
    _, l_first = ttrain.fit(ts, target, SIZE, steps=2, checkpoint_dir=str(cut), verbose=False,
                            **kw)
    assert sorted(p.name for p in cut.iterdir()) == ["step_2.pt"]
    p_res, l_res = ttrain.fit(ts, target, SIZE, steps=4, checkpoint_dir=str(cut), verbose=False,
                              **kw)
    assert l_first + l_res == l_full
    for k in p_full:
        assert torch.equal(p_res[k], p_full[k]), k
    a, b = _opt_state(full, 4), _opt_state(cut, 4)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["params"]["materials.albedo"], b["params"]["materials.albedo"])
    state_a, state_b = a["opt_state"]["state"], b["opt_state"]["state"]
    assert state_a.keys() == state_b.keys() == {0, 1}
    for i in state_a:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state_a[i][name], state_b[i][name]), (i, name)
        assert state_a[i]["exp_avg_sq"].abs().max() > 0
    # the latest checkpoint wins
    restored = ttrain.restore_checkpoint(str(cut), p_full)
    assert restored[2] == 4 and torch.equal(restored[0]["spheres.center"], p_full["spheres.center"])
