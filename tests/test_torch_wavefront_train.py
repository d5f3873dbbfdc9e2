"""Two optimizer steps of the port's wavefront train step
(``make_wf_train_step`` with ``torch.optim.Adam``) against two steps of the
JAX one (``make_wf_train_step`` with ``optax.adam``, ``interpret=True``)
on a procedural scene, from the same params: the losses, and the params
after the steps."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu.ops import pallas_wavefront_grad as jwg
from rt_tpu_torch.ops import wavefront_grad as twg

KEYS = ("materials.albedo", "spheres.center", "spheres.radius")


def test_two_adam_steps_match_optax():
    js = rt_tpu.scene.make_procedural_scene(24)
    ts = rt_tpu_torch.from_jax_scene(js)
    size = (16, 8)
    target = np.random.default_rng(1).uniform(0.0, 0.5, (8, 16, 3)).astype(np.float32)
    p0 = {k: np.asarray(v) * np.float32(0.9) for k, v in jdiff.extract_params(js).items()
          if k in KEYS}
    kw = dict(spp=2, max_bounces=3)
    opt = optax.adam(5e-2)
    step = jwg.make_wf_train_step(opt, js, jnp.asarray(target), size, interpret=True, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    want = []
    for seed in (4, -7):
        jp, state, loss = step(jp, state, seed)
        want.append(float(loss))

    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstep = twg.make_wf_train_step(torch.optim.Adam(list(tp.values()), lr=5e-2), ts, target,
                                   size, device="cpu", **kw)
    got = [float(tstep(tp, seed)) for seed in (4, -7)]
    # each loss is taken before its step's update
    assert got == pytest.approx(want, rel=1e-5)
    # Adam moves each element by lr x m_hat / sqrt(v_hat), about lr per step
    # whatever the gradient's scale, so the gradients' 2e-3 agreement bounds
    # the params' to about 2 x 5e-2 x 2e-3 = 2e-4.  A gradient element within
    # the atol of zero (2e-4 x its key's largest) agrees only to its atol,
    # and the ratio moves with it: the sphere centres' smallest gradients
    # differ by up to 1% between the packages here (float rounding: XLA's
    # CPU FMAs, torch's CPU sqrt), so the centres are held to 2 x lr x 1%.
    for k, atol in zip(KEYS, (3e-4, 1e-3, 3e-4)):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=atol,
                                   err_msg=k)
        assert np.abs(tp[k].numpy() - p0[k]).max() > 0.05, k
