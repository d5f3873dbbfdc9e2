"""Three optimizer steps of the port's blockwise train step
(``train.make_kernel_train_step`` with ``torch.optim.Adam``) against three
steps of the JAX one (``make_kernel_train_step`` with ``optax.adam``,
``rng_impl="hash", interpret=True``) on a procedural scene, from the same
params: the losses, and the params after the steps."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu import train as jtrain
from rt_tpu_torch import train as ttrain

KEYS = ("materials.albedo", "spheres.center", "spheres.radius")


def test_three_adam_steps_match_optax():
    js = rt_tpu.scene.make_procedural_scene(24)
    ts = rt_tpu_torch.from_jax_scene(js)
    size = (16, 8)
    target = np.random.default_rng(0).uniform(0.0, 0.5, (8, 16, 3)).astype(np.float32)
    p0 = {k: np.asarray(v) * np.float32(0.9) for k, v in jdiff.extract_params(js).items()
          if k in KEYS}
    kw = dict(spp=1, max_bounces=3)
    opt = optax.adam(5e-2)
    step = jtrain.make_kernel_train_step(opt, js, jnp.asarray(target), size, rng_impl="hash",
                                         interpret=True, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    want = []
    for i in range(3):
        jp, state, loss = step(jp, state, i)
        want.append(float(loss))

    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstep = ttrain.make_kernel_train_step(torch.optim.Adam(list(tp.values()), lr=5e-2), ts,
                                          target, size, device="cpu", **kw)
    got = [float(tstep(tp, i)) for i in range(3)]
    # each loss is taken before its step's update: the first at equal params,
    # the later ones after updates that agree as below
    assert got == pytest.approx(want, rel=1e-5)
    # Adam normalises each update to about lr = 5e-2 per step whatever the
    # gradient's scale, so the gradients' agreement (2e-3 relative, see
    # test_torch_blockwise_grad.py) bounds the params' to ~3 x 5e-2 x 2e-3
    # = 3e-4; the float32 rounding of the bias corrections adds < 1e-5
    # (test_adam_matches_optax)
    for k in KEYS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=3e-4,
                                   err_msg=k)
        assert np.abs(tp[k].numpy() - p0[k]).max() > 0.1, k
