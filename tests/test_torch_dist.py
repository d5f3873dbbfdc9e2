"""rt_tpu_torch.dist on the CPU: the ('rays', 'prims') mesh of a Gloo world
of 4 ranks (one world for the whole file, started by a module fixture
through ``dist.run_local``; each rank runs ``torch_dist_ranks.jnp_rank``
with one torch thread), against the port's unsharded integrator bit for
bit and against the JAX package's ``dist`` on the 8 virtual CPU devices of
tests/conftest.py.

* The sharded frame equals ``integrator.render_image`` bit for bit on the
  (4, 1), (2, 2) and (1, 4) meshes (the JAX package's test_dist shapes),
  and JAX's sharded frame on a (2, 4) mesh within the tolerance of
  test_torch_integrator.py.
* Loss and gradients through the sharded renderer on (2, 2), both
  ``grad_mode``s, against the port's unsharded ``diff.loss_and_grad`` with
  JAX's own test's tolerances, and against
  ``jax.value_and_grad(diff.image_loss)`` through JAX's sharded renderer
  on (4, 2) (the loss to JAX's rel 1e-6, the gradients within JAX's
  sharding tolerances beyond the port's unsharded gap to JAX).
* The prims-sharded replay's value equals the unsharded replay's, with no
  downgrade warning; ``--mesh 2x2`` through the CLI writes the unsharded
  CLI's frame; ``--mesh`` with the rasterizer is rc 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
import torch_dist_ranks as R
from rt_tpu import diff as jdiff
from rt_tpu import dist as jdist
from rt_tpu_torch import cli, dist
from rt_tpu_torch.ops.intersect import closest_hit
from test_torch_common import SCENES, assert_frames_close


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    res = dist.run_local(R.jnp_rank, 4, str(out), device="cpu", threads=1, timeout=120,
                         collective_timeout=60)
    return res, out


def test_every_rank_holds_the_whole_frame(world):
    res, _ = world
    assert [r["rank"] for r in res] == [0, 1, 2, 3]
    for r in res[1:]:
        for shape in R.MESHES:
            assert torch.equal(r[("basic", shape)], res[0][("basic", shape)])
            assert torch.equal(r[("proc", shape)], res[0][("proc", shape)])
        assert torch.equal(r[("grad", "replay")][0], res[0][("grad", "replay")][0])


def test_mesh_shapes_and_mismatch(world):
    r = world[0][0]
    assert r["mesh_41"] == (4, 1) and r["mesh_prims2"] == (2, 2)
    assert "(3, 1)" in r["mismatch"] and "4 ranks" in r["mismatch"]


@pytest.mark.parametrize("shape", R.MESHES)
@pytest.mark.parametrize("name", ["basic", "proc"])
def test_sharded_matches_unsharded_bitwise(world, name, shape):
    scene, case = (R.basic(), R.BASIC) if name == "basic" else (R.proc100(), R.PROC)
    want = R.render(scene, None, case)
    assert torch.equal(world[0][0][(name, shape)], want)


def test_sharded_matches_jax_sharded(world):
    """The port's (2, 2) frame against JAX's dist.render_image_sharded on a
    (2, 4) mesh."""
    c = dict(R.BASIC)
    size, key = c.pop("size"), c.pop("seed")
    want = jdist.render_image_sharded(rt_tpu.load(str(SCENES / "basic.toml")), size,
                                      rt_tpu.rng.make_key(key), jdist.make_mesh(2, 4), **c)
    assert_frames_close(world[0][0][("basic", (2, 2))], np.asarray(want))


@pytest.mark.parametrize("grad_mode,atol,rtol", [("autodiff", 1e-5, 1e-4),
                                                 ("replay", 1e-6, 1e-5)])
def test_sharded_gradients_match_unsharded(world, grad_mode, atol, rtol):
    """The (2, 2) mesh's loss and gradients against the port's unsharded
    ``diff.loss_and_grad``, with the JAX package's own sharded-against-
    unsharded tolerances (tests/test_dist.py)."""
    loss, got = world[0][0][("grad", grad_mode)]
    want_loss, want = R.grads(None, grad_mode)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("grad_mode,atol,rtol", [("autodiff", 1e-5, 1e-4),
                                                 ("replay", 1e-6, 1e-5)])
def test_sharded_gradients_match_jax(world, grad_mode, atol, rtol):
    """The (2, 2) mesh's loss and gradients against
    ``jax.value_and_grad(diff.image_loss)`` through JAX's sharded renderer
    on (4, 2): the loss to JAX's rel 1e-6, and each gradient entry within
    JAX's sharding tolerances of JAX's, beyond the gap that the port's
    unsharded gradient already has there.  That gap (XLA's CPU backend
    contracts a*b+c into FMAs; up to 2e-3 x max|g| on the camera here,
    which test_torch_loss.py's tolerances cover) is far past JAX's sharding
    tolerances, so those bound only what sharding adds."""
    js = rt_tpu.scene.make_procedural_scene(100, spp=1)
    c = dict(R.GRAD)
    size, key = c.pop("size"), rt_tpu.rng.make_key(c.pop("seed"))
    target = jnp.zeros((size[1], size[0], 3))
    mesh = jdist.make_mesh(4, 2)
    fn = jax.jit(lambda p: jax.value_and_grad(jdiff.image_loss)(
        p, js, target, size, key, grad_mode=grad_mode, **c,
        render_fn=lambda sc, sz, k, **o: jdist.render_image_sharded(sc, sz, k, mesh, **o)))
    want_loss, want = fn(jdiff.extract_params(js))
    _, port_single = R.grads(None, grad_mode)
    loss, got = world[0][0][("grad", grad_mode)]
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        gap = np.abs(port_single[k].numpy() - w)
        excess = np.abs(got[k].numpy() - w) - gap - (atol + rtol * np.abs(w))
        assert excess.max() <= 0, (k, excess.max())


def test_sharded_replay_value_bitwise_and_no_downgrade(world):
    r = world[0][0]
    assert torch.equal(r["replay_value"], R.render(R.proc100(), None, R.PROC,
                                                   grad_mode="replay"))
    assert all("downgrading" not in x["stderr"] for x in world[0])


def test_cli_mesh_writes_the_unsharded_frame(world, tmp_path):
    res, out = world
    assert [r["cli_rc"] for r in res] == [0, 0, 0, 0]
    assert cli.main(R.CLI_ARGS + ["--out", str(tmp_path / "single.npy")]) == 0
    got = np.load(out / "cli_mesh.npy")
    assert got.shape == (24, 32, 3)
    np.testing.assert_array_equal(got, np.load(tmp_path / "single.npy"))


def test_cli_mesh_rejects_other_renderers(capsys):
    assert cli.main(["--renderer", "rasterizer", "--mesh", "4", "--device", "cpu"]) == 2
    assert "only supported for the path tracers" in capsys.readouterr().err
    assert cli.main(["--mesh", "2y2", "--device", "cpu"]) == 2


def test_shard_spheres_padding_is_inert():
    s = R.basic()
    padded = dist.shard_spheres(s, 3)
    n = s.spheres.center.shape[0]
    assert padded.spheres.center.shape[0] % 3 == 0 and padded.spheres.center.shape[0] > n
    assert (padded.spheres.center[n:] == 1e9).all() and (padded.spheres.radius[n:] == 0).all()
    assert (padded.spheres.material[n:] == 0).all()
    assert dist.shard_spheres(s, 4) is s  # a table that divides the axis is kept as it is
    # every row of the padded table scanned (as a shard scans its slice) finds
    # the hits of the scene's own rows
    g = np.random.default_rng(2)
    o = torch.from_numpy(g.uniform(-2, 2, (4096, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(g.normal(size=(4096, 3))
                                                       .astype(np.float32)), dim=-1)
    every_row = dataclasses.replace(padded.spheres, count=padded.spheres.center.shape[0])
    got = closest_hit(every_row, s.planes, s.boxes, o, d)
    want = closest_hit(s.spheres, s.planes, s.boxes, o, d)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_shapes_of_the_port_and_jax_agree():
    """The ranks load the scenes with the port's own loader; the JAX
    comparisons above load them with JAX's: the same tables."""
    a = rt_tpu_torch.from_jax_scene(rt_tpu.scene.make_procedural_scene(100, spp=1))
    b = R.proc100()
    assert torch.equal(a.spheres.center, b.spheres.center)
    assert torch.equal(a.materials.albedo, b.materials.albedo)
