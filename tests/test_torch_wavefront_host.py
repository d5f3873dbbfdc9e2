"""rt_tpu_torch's wavefront route around its two kernels, against
rt_tpu.ops.pallas_wavefront(_grad), rt_tpu.renderer and rt_tpu.train: the
sort key, the two chunk-seed chains, the chunk resolution and sort
schedule, the forward and train-step routers, and the unported knobs.  No
interpret-mode JAX kernel runs here."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import renderer as jreg
from rt_tpu import train as jtrain
from rt_tpu.ops import pallas_blockwise_grad as jbg
from rt_tpu.ops import pallas_wavefront as jwf
from rt_tpu.ops import pallas_wavefront_grad as jwg
from rt_tpu_torch import renderer as treg
from rt_tpu_torch import train as ttrain
from rt_tpu_torch.ops import render as tr
from rt_tpu_torch.ops import wavefront as twf
from rt_tpu_torch.ops import wavefront_grad as twg
from test_torch_common import SCENES
from test_torch_ops import jax_scene

SIZES = (500, 600, 1000, 1600, 2100, 17000)


def _random_states(rng, n):
    """(13, n) states as the bounce kernels leave them: origins spread
    like a scene's (one far ground hit), directions with exact zeros, live
    flags of 0 and 1; then the corner cases: all dead, one live ray, every
    origin equal."""
    s = rng.normal(size=(13, n)).astype(np.float32)
    s[0:3] *= rng.uniform(0.1, 20.0, size=(3, 1)).astype(np.float32)
    s[0, 0] = 990.0
    s[3:6, rng.random(n) < 0.1] = 0.0
    s[12] = (rng.random(n) < 0.6).astype(np.float32)
    dead, one, flat = s.copy(), s.copy(), s.copy()
    dead[12] = 0.0
    one[12] = 0.0
    one[12, 3] = 1.0
    flat[0:3] = 2.5
    return [s, dead, one, flat]


@pytest.mark.parametrize("cell_bits", [1, 2, 3])
def test_sort_key_matches_jax(cell_bits):
    rng = np.random.default_rng(cell_bits)
    for st in _random_states(rng, 3000):
        want = np.asarray(jwf._sort_key(jnp.asarray(st), cell_bits))
        got = twf._sort_key(torch.from_numpy(st), cell_bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the stable sort and the live count of the compaction
        state, ids, n_live = twf._sort_state(torch.from_numpy(st),
                                             torch.arange(3000, dtype=torch.int32), cell_bits)
        perm = np.argsort(want, kind="stable")
        np.testing.assert_array_equal(ids.numpy(), perm)
        np.testing.assert_array_equal(state.numpy(), st[:, perm])
        assert n_live.tolist() == [int((st[12] > 0).sum())]


@pytest.mark.parametrize("seed,n_chunks", [(0, 1), (7, 3), (-5, 4), (2**31 - 2, 5),
                                           (123456789, 6)])
def test_seed_chains_match_jax(seed, n_chunks):
    js = jax_scene("basic.toml")
    # the forward's and the MSE step's chain: pallas_wavefront._wf_meta_rows
    metas = np.asarray(jwf._wf_meta_rows(js, seed, n_chunks))
    np.testing.assert_array_equal(tr._chunk_seeds(seed, n_chunks)[:, 0], metas[:, 0])
    # the train step's chain (pallas_wavefront_grad.py:1220-1228), wrapping int32
    sd, want = jnp.asarray(seed, jnp.int32), []
    for _ in range(n_chunks):
        want.append(int(sd))
        sd = sd * jnp.int32(1103515245) + jnp.int32(12345)
    np.testing.assert_array_equal(twg._train_seeds(seed, n_chunks), want)


def test_chunk_resolution_and_schedule_match_jax(monkeypatch):
    """render_forward_wavefront's spp_chunk, sort schedule and shrink bounce
    for several frame sizes and depths (JAX's frame builder replaced by a
    spy), and _wf_grad_static's chunk."""
    class Resolved(Exception):
        pass

    def spy(**kw):
        raise Resolved(kw)

    monkeypatch.setattr(jwf, "_compiled_frame_wf", spy)
    js = jax_scene("basic.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    cases = [((16, 12), 1, 4, 8), ((16, 12), 9, 4, 3), ((16, 12), 6, 8, 2),
             ((3840, 2160), 8, 8, 8), ((3840, 2160), 256, 16, 6), ((7680, 4320), 8, 4, 1),
             ((20000, 20000), 4, 4, 5)]
    for size, spp, spp_chunk, depth in cases:
        with pytest.raises(Resolved) as e:
            jwf.render_forward_wavefront(js, size, spp=spp, spp_chunk=spp_chunk,
                                         max_bounces=depth)
        kw = e.value.args[0]
        assert twf._resolve_chunk(size, spp, spp_chunk) == kw["spp_chunk"], size
        assert twf._schedule(depth, None, -1) == (kw["sort_schedule"], kw["shrink_at"]), depth
        got = twg._wf_grad_static(ts, size, spp, spp_chunk)
        assert got == jwg._wf_grad_static(js, size, spp, spp_chunk), size
    for sched, shrink in (((1, 3), -1), ((1,), -1), ((2, 4), 4), ((1, 2, 5), None)):
        with pytest.raises(Resolved) as e:
            jwf.render_forward_wavefront(js, (8, 6), spp=1, max_bounces=8, sort_schedule=sched,
                                         shrink_at=shrink)
        kw = e.value.args[0]
        assert twf._schedule(8, sched, shrink) == (kw["sort_schedule"], kw["shrink_at"])
    with pytest.raises(ValueError, match="shrink_at"):
        twf._schedule(8, (1, 2), 3)
    with pytest.raises(ValueError, match="int32 ray ids"):
        twf._resolve_chunk((40000, 30000), 1, 1)


def test_auto_route_matches_jax():
    seen = set()
    for n in SIZES:
        js = rt_tpu.scene.make_procedural_scene(n)
        ts = rt_tpu_torch.from_jax_scene(js)
        assert twf.wavefront_supported(ts) == jwf.wavefront_supported(js), n
        assert twg.wf_grad_supported(ts) == jwg.wf_grad_supported(js), n
        want, _ = jreg.auto_route(js, "tpu")
        seen.add(want)
        if want == "jnp":
            with pytest.raises(NotImplementedError, match="jnp integrator"):
                treg.auto_route(ts, "cuda")
        else:
            assert treg.auto_route(ts, "cuda") == want == treg.auto_route(ts, "cpu"), n
    assert seen == {"pallas", "blockwise", "wavefront", "jnp"}


def test_train_router_matches_jax(monkeypatch):
    """make_kernel_train_step picks the step rt_tpu.train picks (both
    packages' step builders replaced by spies) at the routing sizes."""
    class Picked(Exception):
        pass

    from rt_tpu_torch.ops import blockwise_grad as tbg

    for mod, name in ((jbg, "make_bw_train_step"), (jwg, "make_wf_train_step"),
                      (tbg, "make_bw_train_step"), (twg, "make_wf_train_step")):
        def spy(*a, _name=name, **kw):
            raise Picked(_name)
        monkeypatch.setattr(mod, name, spy)
    opt = torch.optim.Adam([torch.zeros(1)])
    seen = set()
    for n in SIZES:
        js = rt_tpu.scene.make_procedural_scene(n)
        with pytest.raises(Picked) as want:
            jtrain.make_kernel_train_step(optax.adam(1e-2), js, None, (8, 8))
        with pytest.raises(Picked) as got:
            ttrain.make_kernel_train_step(opt, rt_tpu_torch.from_jax_scene(js), None, (8, 8),
                                          device="cpu")
        assert str(got.value) == str(want.value), n
        seen.add(str(want.value))
    assert seen == {"make_bw_train_step", "make_wf_train_step"}


def test_unported_knobs_and_limits():
    ts = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    for knob in ("block", "cull", "cull_group", "cull_gen", "order", "sort_mode", "pipeline",
                 "wf_rows", "extract_window", "dbg", "interpret"):
        with pytest.raises(TypeError):
            twf.render_forward_wavefront(ts, (8, 6), device="cpu", **{knob: None})
    with pytest.raises(ValueError, match="hash"):
        twf.render_forward_wavefront(ts, (8, 6), rng_impl="hw", device="cpu")
    with pytest.raises(ValueError, match="limits"):
        twf.render_forward_wavefront(rt_tpu_torch.scene.make_procedural_scene(17000), (8, 6),
                                     device="cpu")
    box = rt_tpu_torch.from_jax_scene(jax_scene("box"))
    with pytest.raises(ValueError, match="limits"):
        twg.make_wf_mse_step({}, box, np.zeros((6, 8, 3), np.float32), (8, 6), device="cpu")
    with pytest.raises(TypeError):
        twg.make_wf_mse_step({}, ts, np.zeros((6, 8, 3), np.float32), (8, 6), device="cpu",
                             cull=True)
