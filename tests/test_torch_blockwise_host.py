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
from rt_tpu_torch.ops import tables as tt
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
        assert tt._bucket(n) == jb._bucket(n), n


@pytest.mark.parametrize("name", ["basic.toml", "cornell_spheres.toml", "box", "proc700"])
@pytest.mark.parametrize("personality", ["mg", "sm"])
def test_padded_tables_match_jax(name, personality):
    js = rt_tpu.scene.make_procedural_scene(700) if name == "proc700" else jax_scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    for include_boxes in (False, True):
        *got, counts = tt._padded_tables(ts, personality, include_boxes, torch.device("cpu"))
        for want, tab, n in zip(jb._flatten_primitives(js, personality), got, counts):
            assert n == want.shape[1]
            np.testing.assert_array_equal(tab.numpy(),
                                          jb._padded_table(want, jb._bucket(want.shape[1])))
        want_pad, want_tab = jb._box_inputs(js, personality, include_boxes)
        assert got[2].shape == (want_pad, 16)
        if want_pad:
            assert counts[2] == js.boxes.count
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want_tab[0]))
        else:
            assert counts[2] == 0 and want_tab == ()


@pytest.mark.parametrize("seed,n_chunks", [(0, 1), (7, 3), (-5, 4), (2**31 - 2, 5)])
def test_meta_rows_seed_chain_is_chunk_seeds(seed, n_chunks):
    js = jax_scene("box")
    metas = np.asarray(jb._meta_rows(js, seed, n_chunks))
    np.testing.assert_array_equal(tr._chunk_seeds(seed, n_chunks)[:, 0], metas[:, 0])
    assert (metas[:, 1:] == [js.spheres.count, js.planes.count, 0, js.boxes.count]).all()


def test_gates_and_auto_route_match_jax():
    """The gates (megakernel, blockwise cap, boxes, "jnp") are JAX's, with
    and without boxes; the port routes every scene JAX sends to the
    wavefront to blockwise instead (the H100's measured crossover: none)."""
    seen, got = set(), set()
    for label, js in _scenes():
        ts = rt_tpu_torch.from_jax_scene(js)
        assert tbg.bw_grad_supported(ts) == jbg.bw_grad_supported(js), label
        for include_boxes in (False, True):
            assert (tb.blockwise_supported(ts, include_boxes)
                    == jb.blockwise_supported(js, include_boxes)), label
            want, _ = jreg.auto_route(js, "tpu", include_boxes)
            seen.add(want)
            want = "blockwise" if want == "wavefront" else want
            # on the CPU too the port takes the kernel routes (their plain
            # versions) where the JAX package takes "jnp" for every scene
            route = treg.auto_route(ts, "cuda", include_boxes)
            assert route == want, (label, include_boxes)
            assert treg.auto_route(ts, "cpu", include_boxes) == want, (label, include_boxes)
            got.add(route)
    assert seen == {"pallas", "blockwise", "wavefront", "jnp"}
    assert got == {"pallas", "blockwise", "jnp"}


def test_train_step_router_matches_jax(monkeypatch):
    """make_kernel_train_step builds the blockwise step wherever the
    kernels take the scene, on both sides of the 1024-row threshold past
    which rt_tpu.train picks the wavefront step (JAX's builders replaced
    by spies, the port's blockwise builder by a recording wrapper)."""
    class Picked(Exception):
        pass

    import rt_tpu.ops.pallas_wavefront_grad as jwg

    for mod, name in ((jbg, "make_bw_train_step"), (jwg, "make_wf_train_step")):
        def spy(*a, _name=name, **kw):
            raise Picked(_name)
        monkeypatch.setattr(mod, name, spy)
    built = []

    def record(*a, _make=tbg.make_bw_train_step, **kw):
        built.append(a[1].spheres.count)
        return _make(*a, **kw)
    monkeypatch.setattr(tbg, "make_bw_train_step", record)
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
            assert callable(step) and built[-1] == ts.spheres.count, n
        else:
            with pytest.raises(ValueError, match="limits"):
                ttrain.make_kernel_train_step(opt, ts, np.zeros((8, 8, 3), np.float32), (8, 8),
                                              device="cpu")
        seen.add((want, tbg.bw_grad_supported(ts)))
    assert seen == {("make_bw_train_step", True), ("make_wf_train_step", True),
                    ("make_bw_train_step", False)}


@pytest.mark.parametrize("name,personality", [("proc700", "mg"), ("cornell_spheres.toml", "sm"),
                                              ("box", "mg")])
def test_tables_torch_match_tables_jnp(name, personality):
    """The params builder against ``_tables_jnp``, and every builder against
    the forward route's host set-up of the scene at those params: the
    padded tables but for the index column (no kernel reads it), and the
    render kernel's tables, which are the padded tables' used rows (with
    boxes: the box scene, which the params builder refuses)."""
    js = rt_tpu.scene.make_procedural_scene(700) if name == "proc700" else jax_scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    size = (40, 30)
    jp = jdiff.extract_params(js)
    jp = dict(jp, **{"materials.albedo": jp["materials.albedo"] * 0.7,
                     "spheres.radius": jp["spheres.radius"] * 1.1})
    tp = tdiff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    concrete = tdiff.apply_params(ts, tp)
    cpu = torch.device("cpu")
    *padded, counts = tt._padded_tables(concrete, personality, True, cpu)
    for tab, rows, n, used in zip(padded, tt._unrolled_tables(concrete, personality, True, cpu),
                                  counts, (10, 10, 12)):
        assert rows.shape == (n, used) and torch.equal(rows, tab[:n, :used])
    cam = torch.from_numpy(tt._pack_camera(concrete.camera, size))
    if name == "box":
        assert counts[2] == js.boxes.count > 0
        with pytest.raises(ValueError, match="no boxes"):
            tt._param_tables(ts, personality, size, "cpu")
        return
    want = jbg._tables_jnp(js, jp, personality, jb._bucket(js.spheres.count),
                           jb._bucket(js.planes.count), size)
    got = tt._param_tables(ts, personality, size, "cpu")(tp)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got, (*padded[:2], cam)):
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
    sp, pl, bx, counts = tt._padded_tables(ts, "mg", False, torch.device("cpu"))
    assert sp.shape == (128, 16) and counts == (30, 0, 0)
    cam = torch.from_numpy(tt._pack_camera(ts.camera, (8, 6)))
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
