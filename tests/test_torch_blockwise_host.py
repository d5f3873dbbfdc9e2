"""rt_tpu_torch's blockwise route around its two kernels, against
rt_tpu.ops.pallas_blockwise(_grad) and rt_tpu.train: the table buckets and
padded tables, the chunk seeds, the scene gates, the forward and train-step
routers, the tables rebuilt from the params on the device, and
torch.optim.Adam against optax.adam.  No interpret-mode JAX kernel runs
here."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu import renderer as jreg
from rt_tpu import train as jtrain
from rt_tpu.ops import pallas_blockwise as jb
from rt_tpu.ops import pallas_blockwise_grad as jbg
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch import renderer as treg
from rt_tpu_torch import train as ttrain
from rt_tpu_torch.ops import blockwise as tb
from rt_tpu_torch.ops import blockwise_grad as tbg
from rt_tpu_torch.ops import render as tr
from test_torch_common import BOX_TOML, SCENES
from test_torch_ops import jax_scene


def _boxes_toml(n):
    """basic.toml (3 spheres) plus ``n`` small boxes."""
    rows = ",\n".join(f"  {{ material = {i % 3}, position = [{i % 40 * 0.1}, 0.2, "
                      f"{-3 - i // 40 * 0.1}], extents = [0.02, 0.02, 0.02] }}"
                      for i in range(n))
    return (SCENES / "basic.toml").read_text() + f"\nboxes = [\n{rows}\n]\n"


def _scenes():
    """(label, JAX scene) pairs over the routing thresholds: 3, 700 and 2100
    spheres, past the cap, and box counts past the unrolled cap."""
    out = [(f"proc{n}", rt_tpu.scene.make_procedural_scene(n)) for n in (3, 700, 2100, 17000)]
    out += [("basic+box", jax_scene("box"))]
    out += [(f"basic+{n}boxes", rt_tpu.loads(_boxes_toml(n))) for n in (700, 2100)]
    return out


def test_bucket_matches_jax():
    for n in (0, 1, 127, 128, 129, 511, 512, 513, 700, 1024, 1025, 2047, 2048, 16384):
        assert tb._bucket(n) == jb._bucket(n), n


@pytest.mark.parametrize("name", ["basic.toml", "cornell_spheres.toml", "box", "proc700"])
@pytest.mark.parametrize("personality", ["mg", "sm"])
def test_padded_tables_match_jax(name, personality):
    js = rt_tpu.scene.make_procedural_scene(700) if name == "proc700" else jax_scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    for want, got in zip(jb._flatten_primitives(js, personality),
                         tr._flatten_primitives(ts, personality)):
        np.testing.assert_array_equal(tb._padded_table(got, tb._bucket(got.shape[1])),
                                      jb._padded_table(want, jb._bucket(want.shape[1])))
    for include_boxes in (False, True):
        want_pad, want_tab = jb._box_inputs(js, personality, include_boxes)
        got_pad, got_tab = tb._box_inputs(ts, personality, include_boxes)
        assert got_pad == want_pad
        if want_pad:
            np.testing.assert_array_equal(got_tab, np.asarray(want_tab[0]))
        else:
            assert got_tab is None and want_tab == ()


@pytest.mark.parametrize("seed,n_chunks", [(0, 1), (7, 3), (-5, 4), (2**31 - 2, 5)])
def test_meta_rows_seed_chain_is_chunk_seeds(seed, n_chunks):
    js = jax_scene("box")
    metas = np.asarray(jb._meta_rows(js, seed, n_chunks))
    np.testing.assert_array_equal(tr._chunk_seeds(seed, n_chunks)[:, 0], metas[:, 0])
    assert (metas[:, 1:] == [js.spheres.count, js.planes.count, 0, js.boxes.count]).all()


def test_gates_and_auto_route_match_jax():
    seen = set()
    for label, js in _scenes():
        ts = rt_tpu_torch.from_jax_scene(js)
        assert tbg.bw_grad_supported(ts) == jbg.bw_grad_supported(js), label
        for include_boxes in (False, True):
            assert (tb.blockwise_supported(ts, include_boxes)
                    == jb.blockwise_supported(js, include_boxes)), label
            want, _ = jreg.auto_route(js, "tpu", include_boxes)
            seen.add(want)
            # on the CPU too the port takes the kernel routes (their plain
            # versions) where the JAX package takes "jnp" for every scene
            assert treg.auto_route(ts, "cuda", include_boxes) == want, (label, include_boxes)
            assert treg.auto_route(ts, "cpu", include_boxes) == want, (label, include_boxes)
    assert seen == {"pallas", "blockwise", "wavefront", "jnp"}


def test_train_step_router_matches_jax(monkeypatch):
    """make_kernel_train_step sends a scene where rt_tpu.train sends it
    (its two step builders replaced by spies)."""
    class Picked(Exception):
        pass

    import rt_tpu.ops.pallas_wavefront_grad as jwg

    for mod, name in ((jbg, "make_bw_train_step"), (jwg, "make_wf_train_step")):
        def spy(*a, _name=name, **kw):
            raise Picked(_name)
        monkeypatch.setattr(mod, name, spy)
    opt = torch.optim.Adam([torch.zeros(1)])
    seen = set()
    for n in (3, 500, 1000, 1100, 1600, 17000):
        js = rt_tpu.scene.make_procedural_scene(n)
        try:
            jtrain.make_kernel_train_step(optax.adam(1e-2), js, None, (8, 8))
        except Picked as e:
            want = str(e)
        ts = rt_tpu_torch.from_jax_scene(js)
        if tbg.bw_grad_supported(ts):
            step = ttrain.make_kernel_train_step(opt, ts, np.zeros((8, 8, 3), np.float32),
                                                 (8, 8), device="cpu")
            assert callable(step)
        else:
            with pytest.raises(ValueError, match="limits"):
                ttrain.make_kernel_train_step(opt, ts, np.zeros((8, 8, 3), np.float32), (8, 8),
                                              device="cpu")
        seen.add((want, tbg.bw_grad_supported(ts)))
    assert seen == {("make_bw_train_step", True), ("make_wf_train_step", True),
                    ("make_bw_train_step", False)}


@pytest.mark.parametrize("name,personality", [("proc700", "mg"), ("cornell_spheres.toml", "sm")])
def test_tables_torch_match_tables_jnp(name, personality):
    js = rt_tpu.scene.make_procedural_scene(700) if name == "proc700" else jax_scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    size = (40, 30)
    jp = jdiff.extract_params(js)
    jp = dict(jp, **{"materials.albedo": jp["materials.albedo"] * 0.7,
                     "spheres.radius": jp["spheres.radius"] * 1.1})
    s_pad, p_pad = jb._bucket(js.spheres.count), jb._bucket(js.planes.count)
    want = jbg._tables_jnp(js, jp, personality, s_pad, p_pad, size)
    build = tbg._tables_torch(ts, personality, s_pad, p_pad, size, "cpu")
    got = build(tdiff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu"))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the same tables as the forward route's host set-up of the scene at
    # those params, but for the index column (the kernels do not read it)
    concrete = tdiff.apply_params(ts, tdiff.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu"))
    s_tab, p_tab, _, _ = tb._device_tables(concrete, personality, False, torch.device("cpu"))
    cam = torch.from_numpy(tr._pack_camera(concrete.camera, size))
    for g, w in zip(got, (s_tab, p_tab, cam)):
        w = w.clone()
        if w.ndim == 2:
            w[:, 10] = 0.0
        assert torch.equal(g, w)


def test_adam_matches_optax():
    """torch.optim.Adam (the CPU single-tensor loop) against optax.adam on
    the same gradients: both compute m_hat / (sqrt(v_hat) + eps) with betas
    (0.9, 0.999) and eps 1e-8, but torch forms the bias corrections 1 - b^t
    in float64 and divides sqrt(v) by sqrt(1 - b2^t), while optax forms them
    in float32 (0.999 is 1.3e-5 off there) and takes sqrt(v / (1 - b2^t)).
    Each update then differs by up to ~2e-5 of lr: after 5 steps of lr 5e-2
    the params agree within 5 x 5e-2 x 2e-5 = 5e-6."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(12, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    opt = optax.adam(5e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = torch.optim.Adam(list(tp.values()), lr=5e-2)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=5e-6, err_msg=k)
        assert np.abs(tp[k].numpy() - p0[k]).max() > 0.1


def test_unported_knobs_and_limits():
    ts = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    for knob in ("mxu", "scan", "block", "cull", "order", "rng_impl", "interpret"):
        with pytest.raises(TypeError):
            tb.render_forward_blockwise(ts, (8, 6), device="cpu", **{knob: None})
    with pytest.raises(ValueError, match="limits"):
        tb.render_forward_blockwise(rt_tpu_torch.scene.make_procedural_scene(17000), (8, 6),
                                    device="cpu")
    box = rt_tpu_torch.loads((SCENES / "basic.toml").read_text() + BOX_TOML)
    with pytest.raises(ValueError, match="limits"):
        tbg.make_bw_mse_step(tdiff.extract_params(box), box, np.zeros((6, 8, 3), np.float32),
                             (8, 6), device="cpu")


def test_tiles_dispatch_by_device():
    """CPU tensors run the plain versions (no launch is counted, ``out`` is
    added to); another device is refused."""
    ts = rt_tpu_torch.scene.make_procedural_scene(30)
    sp, pl, bx, counts = tb._device_tables(ts, "mg", False, torch.device("cpu"))
    assert sp.shape == (128, 16) and counts == (30, 0, 0)
    cam = torch.from_numpy(tr._pack_camera(ts.camera, (8, 6)))
    seeds = torch.tensor([3], dtype=torch.int32)
    before = (tb.render_blockwise_tile.launches, tbg.bw_grad_tile.launches)
    img = tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, size=(8, 6), spp=2,
                                   max_bounces=3, center_sample=True)
    assert img.shape == (6, 8, 3)
    cot = torch.full((6, 8, 3), 1e-3)
    kw = dict(size=(8, 6), max_bounces=3, center_sample=False)
    one, words = tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=1, words=True, **kw)
    assert one.shape == (6, 8, 3) and words.shape == (3, 48) and words.dtype == torch.int32
    g = tbg.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words, **kw)
    acc = tuple(t.clone() for t in g)
    tbg.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words, out=acc, **kw)
    assert (tb.render_blockwise_tile.launches, tbg.bw_grad_tile.launches) == before
    assert [tuple(t.shape) for t in g] == [(9, 30), (5, 0), (16,)]
    for a, t in zip(acc, g):
        assert torch.equal(a, 2 * t)
    with pytest.raises(ValueError, match="no kernel"):
        tb.render_blockwise_tile(*(t.to("meta") for t in (sp, pl, bx)), counts, cam.to("meta"),
                                 seeds.to("meta"), size=(8, 6), spp=1, max_bounces=1,
                                 center_sample=True)
    with pytest.raises(ValueError, match="cam on"):
        tbg.bw_grad_tile(sp, pl, counts[:2], cam.to("meta"), seeds, cot, words, **kw)
    with pytest.raises(ValueError, match="one sample"):
        tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=2, words=True, **kw)
