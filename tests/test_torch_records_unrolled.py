"""The record kernel's plain PyTorch version (queue 2 row 2) against the
JAX record megakernel (``render_record_pallas(rng_impl="hash",
interpret=True)``): the replay records and the 1-spp radiance, a call of
several samples (one launch a records step) slice by slice, and the pieces
around it (``records_to_flat``, the entry point's gates)."""

import numpy as np
import pytest
import torch

import rt_tpu_torch
from rt_tpu.ops import pallas_render as jr
from rt_tpu_torch.ops import render as tr
from rt_tpu_torch.ops import tables as tt
from test_torch_common import (SCENES, assert_frames_close, assert_records_match,
                               tiles_to_flat)
from test_torch_ops import jax_scene

SIZE, BOUNCES = (24, 16), 3
CASES = {  # id: scene, personality, --boxes, centre sample, rng_mode
    "basic/mg": ("basic.toml", "mg", False, True, "reference"),
    "dielectric/sm": ("dielectric.toml", "sm", False, False, "reference"),
    "cornell/sm sphere": ("cornell_spheres.toml", "sm", False, False, "sphere"),
    "box/mg": ("box", "mg", True, True, "reference"),
}
# the seeds of a 3-sample call on basic/mg: the fixture's seed first
SAMPLE_SEEDS = (5, 6, 7)


@pytest.fixture(scope="module")
def jax_records():
    """The JAX record kernel's output per case, computed once."""
    out = {}
    for cid, (name, pers, boxes, center, rng_mode) in CASES.items():
        out[cid] = jr.render_record_pallas(
            jax_scene(name), SIZE, 5, personality=pers, max_bounces=BOUNCES, rows=8,
            rng_mode=rng_mode, center_sample=center, rng_impl="hash", interpret=True,
            include_boxes=boxes)
    # basic/mg's later samples, off the pixel centre as the records
    # pipeline (pallas_loss_and_grad) calls its kernel after sample 0
    for seed in SAMPLE_SEEDS[1:]:
        out["basic/mg", seed] = jr.render_record_pallas(
            jax_scene("basic.toml"), SIZE, seed, personality="mg", max_bounces=BOUNCES, rows=8,
            rng_mode="reference", center_sample=False, rng_impl="hash", interpret=True)
    return out


def _port(cid):
    name, pers, boxes, center, rng_mode = CASES[cid]
    ts = rt_tpu_torch.from_jax_scene(jax_scene(name))
    return tr.render_record(ts, SIZE, 5, personality=pers, max_bounces=BOUNCES,
                            rng_mode=rng_mode, center_sample=center, include_boxes=boxes,
                            device="cpu")


@pytest.mark.parametrize("cid", list(CASES))
def test_record_tile_matches_jax(jax_records, cid):
    n = SIZE[0] * SIZE[1]
    jrad, jrecs = jax_records[cid]
    rad, recs = _port(cid)
    assert rad.shape == (SIZE[1], SIZE[0], 3)
    assert_records_match(recs, jrecs, n)
    assert_frames_close(rad, tiles_to_flat(jrad, n).T.reshape(SIZE[1], SIZE[0], 3))
    if cid == "box/mg":
        assert (recs["kind"] == 3).any()


def test_records_to_flat_matches_jax(jax_records):
    """The decoder on the JAX kernel's own raw records gives JAX's dict."""
    n = SIZE[0] * SIZE[1]
    _, jrecs = jax_records["dielectric/sm"]
    raw = {k: torch.from_numpy(tiles_to_flat(v, n).copy()) for k, v in jrecs.items()}
    for k in ("kind", "idx", "bits"):
        raw[k] = raw[k].to(torch.int32)
    got = tr.records_to_flat(raw)
    want = jr.records_to_flat(jrecs, n, BOUNCES)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("cid", ["basic/mg", "box/mg"])
def test_record_radiance_is_the_one_spp_frame(cid):
    """The record radiance is render_tile_plain's 1-spp frame, bit for bit,
    and a bounce after the path's end writes kind/idx/bits 0."""
    name, pers, boxes, center, rng_mode = CASES[cid]
    ts = rt_tpu_torch.from_jax_scene(jax_scene(name))
    tabs = tt._unrolled_tables(ts, pers, boxes, torch.device("cpu"))
    cam = torch.from_numpy(tt._pack_camera(ts.camera, SIZE))
    seeds = torch.tensor([-3], dtype=torch.int32)
    kw = dict(size=SIZE, max_bounces=5, center_sample=center, rng_mode=rng_mode)
    rad, recs = tr.render_record_tile(*tabs, cam, seeds, **kw)
    frame = tr.render_tile_plain(*tabs, cam, seeds, spp=1, **kw)
    assert torch.equal(rad, frame)
    live = (recs["bits"] & 16) > 0
    assert not live.all() and live[0].all()
    for k in ("kind", "idx", "bits"):
        assert (recs[k][~live] == 0).all()
    assert torch.equal(live[1:], (recs["bits"][:-1] & 32) > 0)  # alive out -> live in


def test_render_record_gates():
    basic = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    big = rt_tpu_torch.scene.make_procedural_scene(tr.MAX_UNROLL_PRIMS + 1)
    with pytest.raises(ValueError, match="exceeds"):
        tr.render_record(big, (8, 8), 0, device="cpu")
    with pytest.raises(ValueError, match="rng_mode"):
        tr.render_record(basic, (8, 8), 0, rng_mode="threefry", device="cpu")
    before = tr.render_record_tile.launches
    rad, recs = tr.render_record(basic, (8, 4), 0, max_bounces=2, device="cpu")
    assert tr.render_record_tile.launches == before  # the plain version ran
    assert recs["kind"].shape == (2, 32) and recs["jitter"].shape == (2, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tr.render_record(basic, (8, 8), 0)


def _tile_args(cid):
    """The case's record-tile tables and camera on the CPU, and its
    keywords but the centre setting."""
    name, pers, boxes, _, rng_mode = CASES[cid]
    ts = rt_tpu_torch.from_jax_scene(jax_scene(name))
    tabs = tt._unrolled_tables(ts, pers, boxes, torch.device("cpu"))
    cam = torch.from_numpy(tt._pack_camera(ts.camera, SIZE))
    return tabs, cam, dict(size=SIZE, max_bounces=BOUNCES, rng_mode=rng_mode)


@pytest.mark.parametrize("samples", [1, 3])
@pytest.mark.parametrize("cid", ["basic/mg", "dielectric/sm"])
def test_samples_are_the_one_sample_calls_concatenated(cid, samples):
    """The plain version with (S,) seeds is the one-sample calls at each
    seed (sample 0 alone at the pixel centre) laid side by side as the
    replay reads them, bit for bit: each record array (B, S * N), the
    jitter (2, S * N), the radiance (S, H, W, 3)."""
    from rt_tpu_torch.ops.grad import _sample_seeds

    n = SIZE[0] * SIZE[1]
    tabs, cam, kw = _tile_args(cid)
    seeds = torch.from_numpy(_sample_seeds(11, samples))
    rad, recs = tr.render_record_tile_plain(*tabs, cam, seeds, center_sample=True, **kw)
    ones = [tr.render_record_tile_plain(*tabs, cam, seeds[s:s + 1], center_sample=(s == 0), **kw)
            for s in range(samples)]
    assert rad.shape == (samples, SIZE[1], SIZE[0], 3)
    assert torch.equal(rad, torch.cat([r for r, _ in ones]))
    assert set(recs) == set(tr.RECORD_KEYS) | {"jitter"}
    for k in recs:
        assert recs[k].shape == (2 if k == "jitter" else BOUNCES, samples * n), k
        assert torch.equal(recs[k], torch.cat([r[k] for _, r in ones], dim=1)), k
    jitter = recs["jitter"].view(2, samples, n)
    assert (jitter[:, 0] == 0.5).all() and (jitter[:, 1:] != 0.5).any(dim=-1).all()


def test_samples_match_jax(jax_records):
    """Each sample's slice of a 3-sample call on basic/mg against the JAX
    record kernel at that seed, sample 0 at the pixel centre and the
    others not, as the records pipeline calls it."""
    n = SIZE[0] * SIZE[1]
    tabs, cam, kw = _tile_args("basic/mg")
    seeds = torch.tensor(SAMPLE_SEEDS, dtype=torch.int32)
    rad, recs = tr.render_record_tile(*tabs, cam, seeds, center_sample=True, **kw)
    for s, seed in enumerate(SAMPLE_SEEDS):
        jrad, jrecs = jax_records["basic/mg", seed] if s else jax_records["basic/mg"]
        assert_records_match({k: v[:, s * n:(s + 1) * n] for k, v in recs.items()}, jrecs, n)
        assert_frames_close(rad[s], tiles_to_flat(jrad, n).T.reshape(SIZE[1], SIZE[0], 3))
