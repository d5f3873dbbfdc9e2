"""rt_tpu_torch.ops.grad and rt_tpu_torch.diff around the gradient kernels:
the router against the JAX router's choice, the per-sample seeds, the
gradient bookkeeping, the params carry, the device dispatch, and a
finite-difference check through the port's own loss.  No interpret-mode
JAX kernel runs here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import diff as jdiff
from rt_tpu.ops import pallas_grad as jpg
from rt_tpu_torch import diff as tdiff
from rt_tpu_torch.ops import grad as tg
from rt_tpu_torch.ops import render as tr
from test_torch_common import BOX_TOML, SCENES

# spheres and planes sharing materials, and a box (extra param keys)
SHARED_TOML = """
materials = [ { type = 'lambert', albedo = 'red' },
              { type = 'metal', albedo = 'white', roughness = 0.2 },
              { type = 'dielectric' } ]
planes  = [ { material = 0 }, { material = 1, position = [0, 0, -5], normal = [0, 0, 1] } ]
spheres = [ { material = 1, position = [0.0, 1.0, -3.0], radius = 0.5 },
            { material = 0, position = [1.0, 0.5, -2.5], radius = 0.4 },
            { material = 1, position = [-1.0, 0.5, -2.5], radius = 0.3 },
            { material = 2, position = [0.0, 0.4, -1.5], radius = 0.3 } ]
""" + BOX_TOML


def test_route_matches_jax(monkeypatch):
    """The port sends a step where pallas_grad.make_mse_step sends it, over
    a grid of (primitives, spp, bounces); the JAX router is called with its
    pipelines replaced by spies, as tests/test_pallas.py does."""
    class Picked(Exception):
        pass

    for name in ("mono", "multi"):
        def spy(*a, _name=name, **kw):
            raise Picked(_name)
        monkeypatch.setattr(jpg, f"_compiled_pipeline{'_mono' if name == 'mono' else ''}", spy)
    size = (16, 8)
    target = jnp.zeros((size[1], size[0], 3), jnp.float32)
    seen = set()
    for n_prims in (3, 96, 97, 640, 641):
        js = rt_tpu.scene.make_procedural_scene(n_prims)
        params = jdiff.extract_params(js)
        for spp in (1, 4, 16, 17, 64):
            for bounces in (1, 8, 12):
                for mode in ("mono", "multi"):
                    try:
                        jpg.make_mse_step(params, js, target, size, spp=spp,
                                          max_bounces=bounces, mode=mode)
                    except Picked as e:
                        want = str(e)
                    except ValueError:
                        want = "raises"
                    try:
                        got = tg.route(n_prims, spp, bounces, mode)
                    except ValueError:
                        got = "raises"
                    assert got == want, (n_prims, spp, bounces, mode)
                    seen.add(want)
    assert seen == {"mono", "multi", "raises"}


def test_route_rejects_unported_modes():
    with pytest.raises(ValueError, match="not ported"):
        tg.route(3, 4, 8, "chunked")
    with pytest.raises(ValueError, match="unknown mode"):
        tg.route(3, 4, 8, "wavefront")


@pytest.mark.parametrize("seed0", [0, 7, 21474, 21475, 2**31 - 1, -5, -2**31])
def test_sample_seeds_wrap_as_int32(seed0):
    want = np.asarray(jnp.int32(seed0) * jnp.int32(100003) + jnp.arange(9, dtype=jnp.int32))
    np.testing.assert_array_equal(tg._sample_seeds(seed0, 9), want)


def test_assemble_and_pad_match_jax():
    js = rt_tpu.loads(SHARED_TOML)
    ts = rt_tpu_torch.from_jax_scene(js)
    ns, npl = js.spheres.count, js.planes.count
    rng = np.random.default_rng(5)
    sg = rng.normal(size=(9, ns)).astype(np.float32)
    pg9 = rng.normal(size=(9, npl)).astype(np.float32)
    cg = rng.normal(size=16).astype(np.float32)
    s_mat = np.array(js.spheres.material, np.int32)[:ns]
    p_mat = np.array(js.planes.material, np.int32)[:npl]
    tables = (js.spheres.center.shape[0], js.materials.albedo.shape[0])
    want = jpg._pad_missing_grads(
        jpg._assemble_grads(jnp.asarray(sg), jnp.asarray(pg9), jnp.asarray(cg), s_mat, p_mat,
                            *tables), jdiff.extract_params(js))
    t = torch.from_numpy
    got = tg._pad_missing_grads(
        tg._assemble_grads(t(sg), t(pg9[4:9].copy()), t(cg), t(s_mat).long(), t(p_mat).long(),
                           *tables), tdiff.extract_params(ts), torch.device("cpu"))
    assert set(got) == set(want) and "boxes.extents" in got
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_params_carry_bit_for_bit():
    js = rt_tpu.loads(SHARED_TOML)
    jp = jdiff.extract_params(js)
    tp = tdiff.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    ts = rt_tpu_torch.from_jax_scene(js)
    assert set(tp) == set(tdiff.extract_params(ts))
    for k, v in tdiff.extract_params(ts).items():
        assert torch.equal(tp[k], v), k
    # apply_params substitutes: the tables the kernels see follow the params
    tp["materials.albedo"] = tp["materials.albedo"] * 0.5
    moved = tdiff.apply_params(ts, tp)
    want = jdiff.apply_params(js, dict(jp, **{"materials.albedo": jp["materials.albedo"] * 0.5}))
    for pers in ("mg", "sm"):
        for a, b in zip(tr._flatten_primitives(moved, pers), jpg._flatten_primitives(want, pers)):
            np.testing.assert_array_equal(a, b)


def test_fd_through_the_ports_loss():
    """bench.py's gradient check (central FD on materials.reflectivity[0],
    eps 1e-3, seed 17, spp 2, depth 4), at 48x36 on the CPU."""
    ts = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    params = tdiff.extract_params(ts)
    size = (48, 36)
    target = torch.zeros((36, 48, 3))
    kw = dict(seed=17, spp=2, max_bounces=4, device="cpu")
    _, grads = tg.mse_loss_and_grad(params, ts, target, size, **kw)
    name, eps = "materials.reflectivity", 1e-3
    losses = []
    for sign in (1, -1):
        p = dict(params)
        p[name] = params[name].clone()
        p[name][0] += sign * eps
        losses.append(float(tg.mse_loss_and_grad(p, ts, target, size, **kw)[0]))
    fd = (losses[0] - losses[1]) / (2 * eps)
    an = float(grads[name][0])
    assert abs(an - fd) <= max(2e-2 * abs(fd), 1e-4), (an, fd)
    assert abs(an) > 1e-3


def test_mono_and_per_sample_routes_agree():
    """On an mg scene the render kernel's bounce and the gradient kernels'
    forward bounce are the same arithmetic, so both routes compute the same
    loss and gradients up to the order of summation."""
    ts = rt_tpu_torch.loads(SHARED_TOML)
    params = tdiff.extract_params(ts)
    target = torch.from_numpy(np.random.default_rng(2).uniform(0, 0.5, (12, 16, 3)))
    kw = dict(spp=2, max_bounces=3, personality="mg", device="cpu")
    mono = tg.make_mse_step(params, ts, target.float(), (16, 12), mode="mono", **kw)
    multi = tg.make_mse_step(params, ts, target.float(), (16, 12), mode="multi", **kw)
    assert (mono.mode, multi.mode) == ("mono", "multi")
    (l0, g0), (l1, g1) = mono(40000), multi(40000)
    assert float(l0) == pytest.approx(float(l1), rel=1e-6)
    assert set(g0) == set(params) and all(g0[k].shape == params[k].shape for k in params)
    for k in g0:
        scale = max(g0[k].abs().max().item(), 1e-30)
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=k)
    assert not g0["boxes.center"].any() and g0["materials.albedo"].abs().sum() > 0


def test_tiles_dispatch_by_device():
    """CPU tensors run the plain versions (no launch is counted); another
    device is refused; a CUDA step without CUDA raises."""
    ts = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    s_cols, p_cols = tr._flatten_primitives(ts, "mg")
    sp, pl = (torch.from_numpy(np.ascontiguousarray(c.T)) for c in (s_cols, p_cols))
    cam = torch.from_numpy(tr._pack_camera(ts.camera, (8, 6)))
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    tgt = torch.zeros((6, 8, 3))
    kw = dict(size=(8, 6), max_bounces=2)
    before = (tg.mse_step_tile.launches, tg.grad_tile.launches)
    loss, sg, pg, cg = tg.mse_step_tile(sp, pl, cam, seeds, tgt, **kw)
    sg1, pg1, cg1 = tg.grad_tile(sp, pl, cam, seeds[:1], tgt, center_sample=True, **kw)
    assert (tg.mse_step_tile.launches, tg.grad_tile.launches) == before
    assert sg.shape == sg1.shape == (9, 3) and pg.shape == (5, 0) and cg.shape == (16,)
    assert torch.equal(sg, tg.mse_step_tile_plain(sp, pl, cam, seeds, tgt, **kw)[1])
    meta = [t.to("meta") for t in (sp, pl, cam, seeds, tgt)]
    with pytest.raises(ValueError, match="no kernel"):
        tg.mse_step_tile(*meta, **kw)
    with pytest.raises(ValueError, match="cam on"):
        tg.grad_tile(sp, pl, cam.to("meta"), seeds[:1], tgt, center_sample=True, **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tg.make_mse_step(tdiff.extract_params(ts), ts, tgt, (8, 6))
