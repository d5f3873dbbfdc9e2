"""rt_tpu_torch.ops.render against rt_tpu.ops.pallas_render: the pieces
around the forward kernel (counter hash, seed chain, primitive tables,
gates), plus the JAX reference helpers of the test_torch_render_* files.

The frame comparisons live in test_torch_render_*.py, one file per group,
because each interpret-mode JAX render costs 8-20 s on the CPU and the
suite runs files on parallel workers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu.ops import pallas_render as jr
from rt_tpu_torch.ops import render as tr
from rt_tpu_torch.ops import tables as tt
from test_torch_common import BOX_TOML, PLANES_TOML, SCENES


def jax_scene(name: str):
    """A JAX package scene: a file of scenes/, or one of the inline scenes."""
    if name == "planes":
        return rt_tpu.loads(PLANES_TOML)
    if name == "box":
        return rt_tpu.loads((SCENES / "basic.toml").read_text() + BOX_TOML)
    return rt_tpu.load(str(SCENES / name))


def jax_frame(js, size, **kw):
    """The JAX reference frame: the megakernel in interpret mode with the
    portable hash RNG."""
    return np.asarray(jr.render_forward_pallas(js, size, rng_impl="hash", interpret=True,
                                               rows=8, **kw))


def test_hash_u01_bit_exact():
    rng = np.random.default_rng(0)
    # every counter a call can use: up to 4 samples x (2 + 4 x 1000 bounces)
    ctrs = list(range(1, 41)) + [999, 4 * (2 + 4 * 1000), 30103, 65535, 71337]
    per = 4096
    for ctr in ctrs:
        pix = rng.integers(0, 2**31, size=per, dtype=np.int64).astype(np.int32)
        pix[:4] = [0, 1, 2**31 - 1, 2**31 - 2]
        seed = rng.integers(-2**31, 2**31, size=per, dtype=np.int64).astype(np.int32)
        seed[:4] = [0, -1, -2**31, 2**31 - 1]
        want = np.asarray(jr._hash_u01(jnp.asarray(pix), jnp.asarray(seed), ctr, (per,)))
        got = tr.hash_u01(torch.from_numpy(pix).long(), torch.from_numpy(seed).long(), ctr)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"ctr={ctr}")
    assert len(ctrs) * per >= 10**5


@pytest.mark.parametrize("seed,n_chunks,frames", [(0, 1, 1), (7, 3, 1), (3, 4, 2),
                                                  (-5, 3, 3), (2**31 - 2, 5, 1)])
def test_chunk_seeds_equal(seed, n_chunks, frames):
    want = np.asarray(jr._chunk_seeds(seed, n_chunks, frames))
    got = tr._chunk_seeds(seed, n_chunks, frames)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["basic.toml", "dielectric.toml", "cornell_spheres.toml",
                                  "planes", "box"])
@pytest.mark.parametrize("personality", ["mg", "sm"])
def test_flatten_tables_equal(name, personality):
    js = jax_scene(name)
    ts = rt_tpu_torch.from_jax_scene(js)
    s_cols, p_cols, b_cols = tt._flatten(ts, personality, include_boxes=True)
    for want, got in zip(jr._flatten_primitives(js, personality), (s_cols, p_cols)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b_cols, jr._flatten_boxes(js, personality))


def test_pack_camera_matches_jax():
    js = jax_scene("cornell_spheres.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    w, h = 800, 600
    want = np.concatenate([
        np.asarray(js.camera.position, np.float32),
        np.asarray(js.camera.rotation, np.float32).reshape(-1),
        np.asarray([np.tan(js.camera.vfov * 0.5), w / h, js.camera.near, 0.0], np.float32),
    ])
    np.testing.assert_array_equal(tt._pack_camera(ts.camera, (w, h)), want)


def test_supported_gates():
    basic = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    assert tr.supported(basic)
    big = rt_tpu_torch.scene.make_procedural_scene(tr.MAX_UNROLL_PRIMS + 100)
    assert not tr.supported(big)
    edge = rt_tpu_torch.scene.make_procedural_scene(tr.MAX_UNROLL_PRIMS)
    assert tr.supported(edge) == jr.pallas_supported(rt_tpu.scene.make_procedural_scene(640))
    boxy = rt_tpu_torch.loads("materials = [ { type = 'lambert' } ]\nboxes = [ { material = 0 } ]\n")
    assert tr.supported(boxy) and tr.supported(boxy, include_boxes=True)
    with pytest.raises(ValueError, match="exceeds"):
        tr.render_forward(big, (8, 8), spp=1, max_bounces=1, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        tr.make_render_step(big, (8, 8), device="cpu")


def test_render_forward_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a CUDA-less host")
    basic = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.render_forward(basic, (8, 8), spp=1, max_bounces=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.make_render_step(basic, (8, 8), spp=1, max_bounces=1)


def test_render_tile_dispatch_by_device():
    """A CPU tensor runs the plain version (and counts no launch); another
    device is refused."""
    basic = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    sp, pl, bx = tt._unrolled_tables(basic, "mg", False, torch.device("cpu"))
    cam = torch.from_numpy(tt._pack_camera(basic.camera, (8, 6)))
    seeds = torch.tensor([3], dtype=torch.int32)
    kw = dict(size=(8, 6), spp=2, max_bounces=2, center_sample=True)
    before = tr.render_tile.launches
    got = tr.render_tile(sp, pl, bx, cam, seeds, **kw)
    assert tr.render_tile.launches == before
    assert torch.equal(got, tr.render_tile_plain(sp, pl, bx, cam, seeds, **kw))
    with pytest.raises(ValueError, match="no kernel"):
        tr.render_tile(sp.to("meta"), pl.to("meta"), bx.to("meta"), cam.to("meta"),
                       seeds.to("meta"), **kw)
