"""The records route's box-centre gradient on the 660-sphere + 24-box
scene at 960x540, 2 spp, depth 8 (ROADMAP queue 3): the rays that carry it,
replayed on the CPU by both packages on the port's records.

``data/torch_box_centre_rays.npz`` holds the eight rays with the largest
shares of the gradient of ``boxes.center[6, 1]`` (the entry with the
largest gradient), as ``chip_smoke.py --box-rays`` writes them on the card:
per ray the record kernel's camera ray, its records and draws, its weight
in the loss (dL/d radiance) and its share of the gradient; and in ``meta``
the route's analytic gradient and the shares' sum over every ray that
reaches the box.  One ray carries 102.5% of it, along a path of the box,
the ground plane and five spheres; that path is ill-conditioned in
float32: the port's replay in float64 moves the ray's share by 40%.

So the two packages are held to what float32 can decide: the port's CPU
replay, with a correctly rounded square root as the card's, reproduces the
card's shares; and on every ray JAX's replay differs from the port's by no
more than twice what rounding to float32 moves the port's own result (the
float64 replay against the float32 one), and by 1e-5 where that is small.
Both compute the detached-sampling gradient of the same path."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu.replay import PathRecords as JRec
from rt_tpu.replay import replay_radiance as jreplay
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch import replay as trep
from test_torch_common import box_scene_toml

DATA = Path(__file__).parent / "data" / "torch_box_centre_rays.npz"
NAMES = ("kind", "idx", "root_lo", "live_in", "miss", "alive_out", "reflect_bit", "lam_deg")
_TORCH_SQRT = torch.sqrt


def _sqrt_rn(x):
    """A correctly rounded float32 square root, as the card's sqrtf."""
    return _TORCH_SQRT(x.double()).to(x.dtype) if x.dtype == torch.float32 else _TORCH_SQRT(x)


def _rays():
    z = np.load(DATA)
    meta = json.loads(str(z["meta"]))
    # stacked per ray: records (K, B) -> (B, K), unit vectors (K, B, 3) -> (B, K, 3)
    arrays = {k: np.ascontiguousarray(np.swapaxes(z[k], 0, 1)) for k in NAMES + ("ur", "coin")}
    arrays.update({k: z[k] for k in ("o", "d", "weight")})
    return z, meta, arrays


def _jax_replay(js, a, depth):
    """Per-ray radiance and the gradient of sum(weight * radiance) with
    respect to the box centres and extents, by the JAX replay."""
    def f(center, extents):
        sc = jdiff.apply_params(js, {"boxes.center": center, "boxes.extents": extents})
        rad = jreplay(sc, jnp.asarray(a["o"]), jnp.asarray(a["d"]), None,
                      JRec(*(jnp.asarray(a[k]) for k in NAMES)), max_bounces=depth,
                      draws=(jnp.asarray(a["ur"]), jnp.asarray(a["coin"])), include_boxes=True)
        return jnp.sum(rad * jnp.asarray(a["weight"])), rad

    (_, rad), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        js.boxes.center, js.boxes.extents)
    return np.asarray(rad, np.float64), [np.asarray(g, np.float64) for g in grads]


def _to(t, dtype):
    """A scene (or tensor) with its floating tensors in ``dtype``."""
    if isinstance(t, torch.Tensor):
        return t.to(dtype) if t.is_floating_point() else t
    return dataclasses.replace(t, **{f.name: _to(getattr(t, f.name), dtype)
                                     for f in dataclasses.fields(t)
                                     if isinstance(getattr(t, f.name), torch.Tensor)
                                     or dataclasses.is_dataclass(getattr(t, f.name))})


def _torch_replay(ts, a, depth, dtype=torch.float32):
    """As :func:`_jax_replay`, by the port's replay in ``dtype``."""
    ts = _to(ts, dtype)
    f = {k: _to(torch.from_numpy(v), dtype) for k, v in a.items()}
    leaves = [ts.boxes.center.clone().requires_grad_(True),
              ts.boxes.extents.clone().requires_grad_(True)]
    sc = tdiff.apply_params(ts, {"boxes.center": leaves[0], "boxes.extents": leaves[1]})
    rad = trep.replay_radiance(sc, f["o"], f["d"], None,
                               trep.PathRecords(*(f[k] for k in NAMES)), max_bounces=depth,
                               draws=(f["ur"], f["coin"]), include_boxes=True)
    grads = torch.autograd.grad((rad * f["weight"]).sum(), leaves)
    return rad.detach().double().numpy(), [g.double().numpy() for g in grads]


@pytest.mark.skipif(not DATA.exists(), reason="no box-centre rays recorded")
def test_box_centre_rays_replay_as_jax(monkeypatch):
    z, meta, a = _rays()
    js = rt_tpu.loads(box_scene_toml(*meta["scene"]))
    ts = rt_tpu_torch.from_jax_scene(js)
    depth, i, c = meta["depth"], meta["i_box"], meta["c_box"]
    # the shares sum to the route's gradient, and one ray carries it
    assert meta["rays_sum"] == pytest.approx(meta["analytic"], rel=1e-6)
    assert abs(z["contribution"][0]) > abs(meta["analytic"])

    want_rad, want = _jax_replay(js, a, depth)
    rad64, g64 = _torch_replay(ts, a, depth, torch.float64)
    monkeypatch.setattr(torch, "sqrt", _sqrt_rn)
    rad32, g32 = _torch_replay(ts, a, depth)
    # the port's CPU replay is the card's: each ray's share of the entry
    for k in range(len(z["contribution"])):
        one = {key: v[:, k:k + 1] if v.ndim > 1 and key not in ("o", "d", "weight") else v[k:k + 1]
               for key, v in a.items()}
        share = _torch_replay(ts, one, depth)[1][0][i, c]
        assert share == pytest.approx(z["contribution"][k], rel=1e-5, abs=1e-12), k
    # JAX's replay against the port's, within what float32 rounding moves
    # the port's own result
    for got, ref, exact in [(rad32, want_rad, rad64)] + list(zip(g32, want, g64)):
        assert np.isfinite(got).all() and np.isfinite(ref).all()
        slack = 2.0 * np.abs(exact - got) + 1e-5 * max(np.abs(exact).max(), 1e-12)
        assert (np.abs(got - ref) <= slack).all(), np.abs(got - ref).max()
