"""The CUDA kernels (forward render, fused gradient; rows 5, 7, 8 and 9
also with the sharded routes' global offsets) against their plain
PyTorch versions, both on the card, at small sizes.  Needs an NVIDIA GPU with nvcc (marker ``cuda``);
without one every test skips.  On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine need not have.)
chip_smoke.py runs the same comparison at the main path's shapes.
"""

import numpy as np
import pytest
import torch

import rt_tpu_torch
from rt_tpu_torch import diff
from rt_tpu_torch.ops import grad as tg
from rt_tpu_torch.ops import render as tr
from rt_tpu_torch.ops import tables as tt
from test_torch_common import (BOX_TOML, PLANES_TOML, SCENES, assert_frames_close,
                               box_scene_toml, grazing_scene_toml, tie_scene_toml)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _scene(name):
    if name == "planes":
        return rt_tpu_torch.loads(PLANES_TOML)
    if name == "box":
        return rt_tpu_torch.loads((SCENES / "basic.toml").read_text() + BOX_TOML)
    if name.startswith("proc"):
        return rt_tpu_torch.scene.make_procedural_scene(int(name[4:]))
    return rt_tpu_torch.load(str(SCENES / name))


@pytest.mark.parametrize("name,personality,include_boxes,rng_mode", [
    ("basic.toml", "mg", False, "reference"),
    ("dielectric.toml", "sm", False, "reference"),
    ("cornell_spheres.toml", "sm", False, "sphere"),
    ("planes", "mg", False, "reference"),
    ("box", "mg", True, "reference"),
    ("proc64", "mg", False, "reference"),
])
def test_kernel_matches_plain(cuda, name, personality, include_boxes, rng_mode):
    scene = _scene(name)
    size = (48, 32)
    args = [*tt._unrolled_tables(scene, personality, include_boxes, cuda),
            torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda),
            torch.tensor([5, -9], dtype=torch.int32, device=cuda)]
    kw = dict(size=size, spp=3, max_bounces=5, center_sample=True, rng_mode=rng_mode)
    before = tr.render_tile.launches
    got = tr.render_tile(*args, **kw)
    assert tr.render_tile.launches == before + 1
    want = tr.render_tile_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == (2, 32, 48, 3) and torch.isfinite(got).all()
    # built with --fmad=false and 1/sqrtf, the kernel rounds every operation
    # as the plain version does on the card, so the two agree bit for bit
    diff = (got - want).abs()
    assert torch.equal(got, want), (
        f"{int((diff.amax(-1) > 0).sum())} pixels differ (max abs diff {diff.max().item()})")


def test_entry_points_launch_the_kernel(cuda):
    scene = _scene("basic.toml")
    before = tr.render_tile.launches
    img = tr.render_forward(scene, (40, 30), spp=6, max_bounces=4, device=cuda)
    assert tr.render_tile.launches == before + 2  # two sample chunks
    assert img.device.type == "cuda" and img.shape == (30, 40, 3)
    step = tr.make_render_step(scene, (40, 30), spp=6, max_bounces=4, frames=2, device=cuda)
    frames = step(seed=0)
    assert frames.shape == (2, 30, 40, 3)
    torch.testing.assert_close(frames[0], img, rtol=0, atol=0)
    assert_frames_close(img.cpu(), tr.render_forward(scene, (40, 30), spp=6, max_bounces=4,
                                                     device="cpu"))


def test_wrapper_rejects_bad_inputs(cuda):
    scene = _scene("basic.toml")
    sp, pl, bx = tt._unrolled_tables(scene, "mg", False, cuda)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, (8, 8))).to(cuda)
    seeds = torch.tensor([0], dtype=torch.int32, device=cuda)
    kw = dict(size=(8, 8), spp=1, max_bounces=1, center_sample=True)
    with pytest.raises(ValueError, match="seeds"):
        tr.render_tile(sp, pl, bx, cam, seeds.long(), **kw)
    with pytest.raises(ValueError, match="cam"):
        tr.render_tile(sp, pl, bx, cam.cpu(), seeds, **kw)
    with pytest.raises(ValueError, match="spheres"):
        tr.render_tile(sp.t(), pl, bx, cam, seeds, **kw)


def _grad_args(cuda, name, personality, size, seed=1):
    scene = _scene(name)
    sp, pl, _ = tt._unrolled_tables(scene, personality, False, cuda)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    w, h = size
    pix = torch.from_numpy(np.random.default_rng(seed).uniform(0, 0.5, (h, w, 3))
                           .astype(np.float32)).to(cuda)
    return sp, pl, cam, pix


def _assert_within_l1(got, want, l1):
    # same per-ray arithmetic (--fmad=false, same expression order); only
    # the order of the sums over pixels and samples differs (the kernels
    # sum per warp, per block and then over blocks, the per-sample kernel's
    # per-primitive sums with shared-memory atomics): each entry agrees
    # within 1e-5 of the sum of its contributions' magnitudes
    for g, w_, l in zip(got, want, l1):
        assert torch.isfinite(g).all()
        assert ((g - w_).abs() <= 1e-5 * l).all(), ((g - w_).abs() / l.clamp_min(1e-30)).max()


@pytest.mark.parametrize("name,personality,rng_mode", [
    ("basic.toml", "mg", "reference"),
    ("cornell_spheres.toml", "sm", "sphere"),
    ("planes", "mg", "reference"),
])
def test_mono_kernel_matches_plain(cuda, name, personality, rng_mode):
    size = (48, 32)
    sp, pl, cam, tgt = _grad_args(cuda, name, personality, size)
    seeds = torch.tensor([3, -8, 40000], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=6, rng_mode=rng_mode)
    before = tg.mse_step_tile.launches
    got = tg.mse_step_tile(sp, pl, cam, seeds, tgt, **kw)
    assert tg.mse_step_tile.launches == before + 1
    want, l1 = tg.mse_step_tile_plain(sp, pl, cam, seeds, tgt, with_l1=True, **kw)
    torch.cuda.synchronize()
    _assert_within_l1(got, want, l1)


@pytest.mark.parametrize("name,personality,center", [
    ("dielectric.toml", "sm", True),
    ("proc64", "mg", False),
])
def test_grad_kernel_matches_plain(cuda, name, personality, center):
    size = (48, 32)
    sp, pl, cam, cot = _grad_args(cuda, name, personality, size)
    seeds = torch.tensor([77], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=6, center_sample=center)
    before = tg.grad_tile.launches
    got = tg.grad_tile(sp, pl, cam, seeds, cot * 1e-4, **kw)
    assert tg.grad_tile.launches == before + 1
    want, l1 = tg.grad_tile_plain(sp, pl, cam, seeds, cot * 1e-4, with_l1=True, **kw)
    torch.cuda.synchronize()
    _assert_within_l1(got, want, l1)


@pytest.mark.parametrize("name,personality,size,spp,mono", [
    ("basic.toml", "mg", (37, 23), 3, True),        # ragged: 851 pixels
    ("proc90", "mg", (64, 48), 2, True),            # many winners per warp
    ("dielectric.toml", "sm", (37, 23), 1, False),  # ragged, per-sample
    ("proc640", "mg", (48, 32), 1, False),          # the per-sample route's largest table
])
def test_grad_kernels_warp_aggregation(cuda, name, personality, size, spp, mono):
    """Cases the warp-level aggregation of the gradient kernels could get
    wrong: a last warp that runs past the frame (37x23 is no multiple of
    32), many winners in one warp on the mono route, and 640 primitives on
    the per-sample route.  The mono kernel keeps a slot set per warp and
    sums them in a fixed order, so two of its launches agree bit for bit."""
    sp, pl, cam, pix = _grad_args(cuda, name, personality, size)
    if mono:
        assert tg.route(sp.shape[0] + pl.shape[0], spp, 8) == "mono"
        seeds = torch.from_numpy(tg._sample_seeds(5, spp)).to(cuda)
        kw = dict(size=size, max_bounces=8)
        got, again = (tg.mse_step_tile(sp, pl, cam, seeds, pix, **kw) for _ in range(2))
        want, l1 = tg.mse_step_tile_plain(sp, pl, cam, seeds, pix, with_l1=True, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    else:
        seeds = torch.tensor([-31], dtype=torch.int32, device=cuda)
        kw = dict(size=size, max_bounces=8, center_sample=False)
        got = tg.grad_tile(sp, pl, cam, seeds, pix * 1e-4, **kw)
        want, l1 = tg.grad_tile_plain(sp, pl, cam, seeds, pix * 1e-4, with_l1=True, **kw)
        torch.cuda.synchronize()
    _assert_within_l1(got, want, l1)


def test_make_mse_step_launches(cuda):
    """The mono route launches its kernel once per step; the per-sample
    route launches the render kernel and the gradient kernel once per
    sample each."""
    scene = _scene("dielectric.toml")
    params = diff.extract_params(scene)
    size = (40, 30)
    target = torch.zeros((30, 40, 3), device=cuda)
    counts = lambda: (tg.mse_step_tile.launches, tr.render_tile.launches, tg.grad_tile.launches)
    mono = tg.make_mse_step(params, scene, target, size, spp=4, max_bounces=8,
                            personality="sm", device=cuda)
    before = counts()
    loss, grads = mono(seed=1)
    assert mono.mode == "mono"
    assert counts() == (before[0] + 1, before[1], before[2])
    multi = tg.make_mse_step(params, scene, target, size, spp=64, max_bounces=8,
                             personality="sm", device=cuda)
    before = counts()
    loss64, grads64 = multi(seed=1)
    assert multi.mode == "multi"
    assert counts() == (before[0], before[1] + 64, before[2] + 64)
    for g in (grads, grads64):
        assert set(g) == set(params) and all(torch.isfinite(v).all() for v in g.values())
    assert torch.isfinite(loss) and torch.isfinite(loss64)


def _bw_tables(cuda, scene, personality, include_boxes=False):
    return tt._padded_tables(scene, personality, include_boxes, cuda)


@pytest.mark.parametrize("name,personality,include_boxes,rng_mode", [
    ("basic.toml", "mg", False, "reference"),
    ("cornell_spheres.toml", "sm", False, "sphere"),
    ("box", "mg", True, "reference"),
    ("proc700", "mg", False, "reference"),
])
def test_blockwise_kernel_matches_plain(cuda, name, personality, include_boxes, rng_mode):
    from rt_tpu_torch.ops import blockwise as tb

    scene = (rt_tpu_torch.scene.make_procedural_scene(700) if name == "proc700"
             else _scene(name))
    sp, pl, bx, counts = _bw_tables(cuda, scene, personality, include_boxes)
    size = (48, 32)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    seeds = torch.tensor([-9], dtype=torch.int32, device=cuda)
    kw = dict(size=size, spp=3, max_bounces=5, center_sample=True, rng_mode=rng_mode)
    before = tb.render_blockwise_tile.launches
    got = tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, **kw)
    assert tb.render_blockwise_tile.launches == before + 1
    want = tb.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, **kw)
    torch.cuda.synchronize()
    assert got.shape == (32, 48, 3) and torch.isfinite(got).all()
    # the render kernel's per-pixel code (csrc/trace.cuh) with --fmad=false:
    # bit for bit, as the render kernel
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("name,include_boxes", [("ties", True), ("grazing", False),
                                                ("proc2100", False)])
def test_rejecting_scan_kernels_match_plain(cuda, name, include_boxes):
    """The render kernel and both forms of the blockwise kernel run the
    rejecting scan (csrc/trace.cuh scan_spheres_rejecting): on a tie-heavy
    scene (duplicated rows, a sphere on a plane, equal boxes), a grazing
    one (a camera along a radius-1000 sphere, small spheres on it) and past
    the 2048 rows the blockwise kernel stages in shared memory (its rows
    read from device memory), each equals its plain version bit for bit,
    frame and winner words."""
    from rt_tpu_torch.ops import blockwise as tb

    scene = {"ties": lambda: rt_tpu_torch.loads(tie_scene_toml()),
             "grazing": lambda: rt_tpu_torch.loads(grazing_scene_toml()),
             "proc2100": lambda: rt_tpu_torch.scene.make_procedural_scene(2100)}[name]()
    size = (96, 64) if name != "proc2100" else (32, 24)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    seeds = torch.tensor([23], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=8 if name != "proc2100" else 3)
    sp, pl, bx, counts = _bw_tables(cuda, scene, "mg", include_boxes)
    got = tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=3, center_sample=True,
                                   **kw)
    want = tb.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=3,
                                          center_sample=True, **kw)
    img, words = tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=1, words=True,
                                          center_sample=False, **kw)
    img_p, words_p = tb.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1,
                                                    words=True, center_sample=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert torch.equal(img, img_p) and torch.equal(words, words_p)
    if sum(counts) <= tr.MAX_UNROLL_PRIMS:
        args = tt._unrolled_tables(scene, "mg", include_boxes, cuda)
        r_got = tr.render_tile(*args, cam, seeds, spp=3, center_sample=True, **kw)
        r_want = tr.render_tile_plain(*args, cam, seeds, spp=3, center_sample=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(r_got, r_want), (r_got - r_want).abs().max().item()
        assert torch.equal(r_got[0], got)


@pytest.mark.parametrize("name,personality,center", [
    ("cornell_spheres.toml", "sm", True),
    ("proc700", "mg", False),
])
def test_bw_grad_kernel_matches_plain(cuda, name, personality, center):
    from rt_tpu_torch.ops import blockwise_grad as tbg

    scene = (rt_tpu_torch.scene.make_procedural_scene(700) if name == "proc700"
             else _scene(name))
    sp, pl, bx, counts = _bw_tables(cuda, scene, personality)
    size = (48, 32)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    cot = torch.from_numpy(np.random.default_rng(4).uniform(0, 1e-4, (32, 48, 3))
                           .astype(np.float32)).to(cuda)
    seeds = torch.tensor([77], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=6, center_sample=center)
    # the sample's forward launch in its words form (the training step's),
    # bit for bit with the plain version, frame and winner words
    from rt_tpu_torch.ops import blockwise as tb

    img, words = tb.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=1, words=True, **kw)
    img_p, words_p = tb.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1,
                                                    words=True, **kw)
    assert torch.equal(img, img_p) and torch.equal(words, words_p)
    before = tbg.bw_grad_tile.launches
    got = tbg.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words, **kw)
    assert tbg.bw_grad_tile.launches == before + 1
    twice = tbg.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words,
                             out=tuple(g.clone() for g in got), **kw)
    want, l1 = tbg.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot, words, with_l1=True,
                                      **kw)
    torch.cuda.synchronize()
    # per-row gradients are added with global atomics: within 1e-5 x L1
    _assert_within_l1(got, want, l1)
    _assert_within_l1(twice, [2 * w_ for w_ in want], [2 * l for l in l1])


def test_blockwise_entry_points_launch_the_kernels(cuda):
    """The 1000-sphere scene takes the blockwise route (one forward launch
    per 4-sample chunk); the blockwise step launches the forward and the
    gradient kernel once per sample; the train step does the same and
    updates the params in place."""
    from rt_tpu_torch import renderer as treg
    from rt_tpu_torch import train as ttrain
    from rt_tpu_torch.ops import blockwise as tb
    from rt_tpu_torch.ops import blockwise_grad as tbg

    big = rt_tpu_torch.scene.make_procedural_scene(1000)
    assert treg.auto_route(big, "cuda") == "blockwise"
    counts = lambda: (tb.render_blockwise_tile.launches, tbg.bw_grad_tile.launches)
    before = counts()
    img = treg.create("mg_auto")(big, (40, 30), spp=6, max_bounces=4, device=cuda)
    assert counts() == (before[0] + 2, before[1])
    assert img.shape == (30, 40, 3) and torch.isfinite(img).all()
    assert_frames_close(img.cpu(), tb.render_forward_blockwise(big, (40, 30), spp=6, max_bounces=4,
                                                               device="cpu"))
    scene = rt_tpu_torch.scene.make_procedural_scene(200)
    target = tb.render_forward_blockwise(scene, (40, 30), seed=3, spp=2, max_bounces=4,
                                         gamma=False, device=cuda)
    params = {"materials.albedo": torch.full_like(scene.materials.albedo, 0.5).to(cuda)}
    before = counts()
    loss, grads = tbg.bw_mse_loss_and_grad(params, scene, target, (40, 30), spp=3,
                                           max_bounces=4, device=cuda)
    assert counts() == (before[0] + 3, before[1] + 3)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
    opt = torch.optim.Adam(list(params.values()), lr=5e-2, foreach=True)
    step = ttrain.make_kernel_train_step(opt, scene, target, (40, 30), spp=3, max_bounces=4,
                                         device=cuda)
    start = params["materials.albedo"].clone()
    before = counts()
    losses = [float(step(params, i)) for i in range(4)]
    assert counts() == (before[0] + 12, before[1] + 12)
    assert not torch.equal(params["materials.albedo"], start) and losses[-1] < losses[0]


def _wf_scene(name):
    return (rt_tpu_torch.scene.make_procedural_scene(int(name[4:])) if name.startswith("proc")
            else _scene(name))


def _wf_record(cuda, scene, personality, include_boxes, size, spp, max_bounces, rng_mode,
               check_plain):
    """One chunk of the record forward through the kernel, each launch held
    bit for bit against the plain version on the same input table when
    ``check_plain``.  Returns the tables, camera, seeds and the saved
    bounces."""
    from rt_tpu_torch.ops import wavefront as twf

    sp, pl, bx, counts = _bw_tables(cuda, scene, personality, include_boxes)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    seeds = torch.tensor([-77], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=max_bounces, center_sample=True, rng_mode=rng_mode,
              record=True)

    def launch(b, state, ids, limit):
        before = twf.wf_bounce.launches
        if check_plain:
            st, ii = state.clone(), ids.clone()
            want = twf.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st, ii, limit, bounce=b,
                                       **kw)
        got = twf.wf_bounce(sp, pl, bx, counts, cam, seeds, state, ids, limit, bounce=b, **kw)
        assert twf.wf_bounce.launches == before + 1
        if check_plain:
            torch.cuda.synchronize()
            # trace.cuh's bounce with --fmad=false: bit for bit
            assert torch.equal(state, st), (b, (state - st).abs().max().item())
            assert torch.equal(ids, ii) and torch.equal(got, want), b
        return got

    sched, shrink = twf._schedule(max_bounces, None, -1)
    n = size[0] * size[1] * spp
    state, ids, saved = twf._forward_chunk(launch, n, cuda, max_bounces=max_bounces, sched=sched,
                                           shrink_at=shrink, cell_bits=2, record=True)
    return (sp, pl, bx, counts), cam, seeds, state, ids, saved


@pytest.mark.parametrize("name,personality,include_boxes,rng_mode", [
    ("basic.toml", "mg", False, "reference"),
    ("cornell_spheres.toml", "sm", False, "sphere"),
    ("box", "mg", True, "reference"),
    ("proc1600", "mg", False, "reference"),
])
def test_wf_bounce_matches_plain(cuda, name, personality, include_boxes, rng_mode):
    """Every launch of a record forward (gen, then bounces 1-5 with the
    sorts and the live-prefix limit) bit for bit against the plain version,
    and the assembled chunk equal to the blockwise kernel's."""
    from rt_tpu_torch.ops import blockwise as tb
    from rt_tpu_torch.ops import wavefront as twf

    scene = _wf_scene(name)
    size, spp = (48, 32), 2
    tables, cam, seeds, state, ids, _ = _wf_record(cuda, scene, personality, include_boxes, size,
                                                   spp, 6, rng_mode, True)
    img = twf._assemble(state, ids, size[0] * size[1], spp).reshape(32, 48, 3)
    want = tb.render_blockwise_tile(*tables, cam, seeds, size=size, spp=spp, max_bounces=6,
                                    center_sample=True, rng_mode=rng_mode)
    assert torch.equal(img, want)


def _lane_limits(n):
    """{G: a live-prefix length at which a later bounce gives each ray G
    lanes}, G = 1, 2, ..., 32, from the card's rule (``_split_lanes``):
    ceil(R / G), R the resident threads (the least live count that gets
    one lane), which must not exceed the table's n rays."""
    from rt_tpu_torch.ops import wavefront as twf

    assert twf._split_lanes(n) == 1, "the table is smaller than the resident threads"
    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if twf._split_lanes(mid) == 1 else (mid + 1, hi)
    return {g: -(-lo // g) for g in (1, 2, 4, 8, 16, 32)}


@pytest.mark.parametrize("name,include_boxes", [("ties", True), ("sky", False)])
def test_wf_bounce_split_scan_every_g(cuda, name, include_boxes):
    """The later bounces split each live ray's scan over G lanes, G from
    the live count: from the same table after bounce 0, a launch at
    live-prefix limits that leave G = 1, 2, 4, 8, 16 and 32 equals the
    plain version bit for bit (state, ids, winner words); and a whole
    record chunk (its natural live counts, down to a few rays on the
    mostly-sky scene) equals the plain version at every launch and the
    blockwise kernel's chunk.  The tie-heavy scene has sphere rows
    duplicated side by side and across the table, and two equal boxes."""
    from rt_tpu_torch.ops import blockwise as tb
    from rt_tpu_torch.ops import wavefront as twf
    from test_torch_common import SKY_TOML, tie_scene_toml

    scene = rt_tpu_torch.loads(tie_scene_toml() if name == "ties" else SKY_TOML)
    personality = "sm"
    size, spp, depth = (640, 480), 1, 6
    tables, cam, seeds, state, ids, _ = _wf_record(cuda, scene, personality, include_boxes, size,
                                                   spp, depth, "reference", True)
    img = twf._assemble(state, ids, size[0] * size[1], spp).reshape(480, 640, 3)
    want = tb.render_blockwise_tile(*tables, cam, seeds, size=size, spp=spp, max_bounces=depth,
                                    center_sample=True)
    assert torch.equal(img, want)

    n = size[0] * size[1] * spp
    gen_state = torch.empty((twf.STATE_ROWS, n), device=cuda)
    gen_ids = torch.empty(n, dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=depth, center_sample=True, record=True)
    twf.wf_bounce(*tables, cam, seeds, gen_state, gen_ids, bounce=0, **kw)
    alive = int((gen_state[12] > 0).sum())
    seen = set()
    for g, live in _lane_limits(n).items():
        seen.add(twf._split_lanes(min(alive, live)))
        limit = torch.tensor([live], dtype=torch.int32, device=cuda)
        st, ii = gen_state.clone(), gen_ids.clone()
        st_p, ii_p = gen_state.clone(), gen_ids.clone()
        got = twf.wf_bounce(*tables, cam, seeds, st, ii, limit, bounce=1, **kw)
        ref = twf.wf_bounce_plain(*tables, cam, seeds, st_p, ii_p, limit, bounce=1, **kw)
        torch.cuda.synchronize()
        assert torch.equal(st, st_p) and torch.equal(ii, ii_p) and torch.equal(got, ref), g
    # the tie-heavy scene keeps enough rays alive for every G; the
    # mostly-sky one gives its few live rays 32 lanes at every limit
    assert seen == ({1, 2, 4, 8, 16, 32} if name == "ties" else {32}), seen


@pytest.mark.parametrize("name,personality", [
    ("cornell_spheres.toml", "sm"),
    ("proc1600", "mg"),
])
def test_wf_rev_matches_plain(cuda, name, personality):
    """Every reverse launch of a chunk against the plain version on the same
    inputs: the cotangent table close, per-row gradients within 1e-5 x L1
    (float64 atomics in varying order)."""
    from rt_tpu_torch.ops import wavefront_grad as twg

    scene = _wf_scene(name)
    size, spp, depth = (48, 32), 2, 6
    (sp, pl, _, counts), cam, seeds, _, _, saved = _wf_record(cuda, scene, personality, False,
                                                              size, spp, depth, "reference",
                                                              False)
    n_pix = size[0] * size[1]
    cot_pix = torch.from_numpy(np.random.default_rng(6).uniform(-1e-4, 1e-4, (n_pix, 3))
                               .astype(np.float32)).to(cuda)
    cot = torch.zeros((9, n_pix * spp), device=cuda)
    for b in reversed(range(depth)):
        state, ids, words, limit = saved[b]
        cot_plain = cot.clone()
        before = twg.wf_rev.launches
        got = twg.wf_rev(sp, pl, counts[:2], cam, seeds, state, ids, words, limit, cot, cot_pix,
                         size=size, bounce=b, max_bounces=depth, center_sample=True)
        assert twg.wf_rev.launches == before + 1
        want, l1 = twg.wf_rev_plain(sp, pl, counts[:2], cam, seeds, state, ids, words, limit,
                                    cot_plain, cot_pix, size=size, bounce=b, max_bounces=depth,
                                    center_sample=True, with_l1=True)
        torch.cuda.synchronize()
        _assert_within_l1(got, want, l1)
        if b:
            scale = cot_plain.abs().max().clamp_min(1e-30)
            assert (cot - cot_plain).abs().max() <= 1e-5 * scale, b
        cot = cot_plain


@pytest.mark.parametrize("case", ["shared", "own", "mid_warp", "ragged"])
def test_wf_rev_warp_sums(cuda, case):
    """The reverse adds its gradients per warp by winner (bounce.cuh
    warp_add_prim_grad, all 32 lanes at the call): every launch within 1e-5
    x L1 of the plain version where every lane of a warp that hit has the
    same winner (sphere row 7), where every such lane has its own (row =
    ray index modulo the rows), where the live prefix ends mid-warp (limit
    32k + 13), and on a ragged table of 851 rays (37x23, one sample: not a
    multiple of 32).  The misses stay misses, so the sky's cotangent
    reaches the earlier bounces and the sums are not all zero."""
    from rt_tpu_torch.ops import wavefront_grad as twg

    scene = rt_tpu_torch.scene.make_procedural_scene(1600)
    size, spp, depth = ((37, 23), 1, 4) if case == "ragged" else ((48, 32), 2, 4)
    (sp, pl, _, counts), cam, seeds, _, _, saved = _wf_record(cuda, scene, "mg", False, size, spp,
                                                              depth, "reference", False)
    n_pix = size[0] * size[1]
    n = n_pix * spp
    cot_pix = torch.from_numpy(np.random.default_rng(7).uniform(-1e-4, 1e-4, (n_pix, 3))
                               .astype(np.float32)).to(cuda)
    cot = torch.zeros((9, n), device=cuda)
    total = 0.0
    for b in reversed(range(depth)):
        state, ids, words, limit = saved[b]
        miss = (words & tr.WORD_MISS) != 0
        if case == "shared":
            words = torch.where(miss, words, 7)
        elif case == "own":
            own = (torch.arange(words.numel(), device=cuda) % counts[0]).to(torch.int32)
            words = torch.where(miss, words, own)
        elif case == "mid_warp" and b > 0:
            live = int((state[12] > 0).sum())
            limit = torch.tensor([32 * max(live // 64, 1) + 13], dtype=torch.int32, device=cuda)
        cot_plain = cot.clone()
        got = twg.wf_rev(sp, pl, counts[:2], cam, seeds, state, ids, words, limit, cot, cot_pix,
                         size=size, bounce=b, max_bounces=depth, center_sample=True)
        want, l1 = twg.wf_rev_plain(sp, pl, counts[:2], cam, seeds, state, ids, words, limit,
                                    cot_plain, cot_pix, size=size, bounce=b, max_bounces=depth,
                                    center_sample=True, with_l1=True)
        torch.cuda.synchronize()
        _assert_within_l1(got, want, l1)
        total += float(want[0].abs().sum() + want[1].abs().sum())
        if b:
            scale = cot_plain.abs().max().clamp_min(1e-30)
            assert (cot - cot_plain).abs().max() <= 1e-5 * scale, b
        cot = cot_plain
    assert total > 0  # the launches added gradients


def test_wavefront_entry_points_launch_the_kernels(cuda):
    """mg_wavefront (one gen and 3 bounce launches per chunk at depth 4)
    renders the blockwise frame bit for bit, which mg_auto renders on the
    blockwise route at 1600 spheres; the wavefront step at 1 spp equals
    the blockwise step at matched draws; make_wf_train_step makes 4 + 4
    launches per chunk and lowers the loss, and make_kernel_train_step
    launches no wavefront kernel."""
    from rt_tpu_torch import renderer as treg
    from rt_tpu_torch import train as ttrain
    from rt_tpu_torch.ops import blockwise as tb
    from rt_tpu_torch.ops import blockwise_grad as tbg
    from rt_tpu_torch.ops import wavefront as twf
    from rt_tpu_torch.ops import wavefront_grad as twg

    big = rt_tpu_torch.scene.make_procedural_scene(1600)
    assert treg.auto_route(big, "cuda") == "blockwise"
    counts = lambda: (twf.wf_bounce.launches, twg.wf_rev.launches)
    before = counts()
    img = treg.create("mg_wavefront")(big, (40, 30), spp=6, max_bounces=4, device=cuda)
    assert counts() == (before[0] + 8, before[1])
    assert torch.equal(img, tb.render_forward_blockwise(big, (40, 30), spp=6, max_bounces=4,
                                                        device=cuda))
    assert torch.equal(img, treg.create("mg_auto")(big, (40, 30), spp=6, max_bounces=4,
                                                   device=cuda))
    assert counts() == (before[0] + 8, before[1])
    size = (40, 30)
    target = torch.from_numpy(np.random.default_rng(2).uniform(0, 0.5, (30, 40, 3))
                              .astype(np.float32)).to(cuda)
    params = diff.extract_params(big)
    lw, gw = twg.wf_mse_loss_and_grad(params, big, target, size, seed=7 * 100003, spp=1,
                                      max_bounces=4, device=cuda)
    lb, gb = tbg.bw_mse_loss_and_grad(params, big, target, size, seed=7, spp=1, max_bounces=4,
                                      device=cuda)
    assert lw.item() == lb.item()
    for k in gb:
        assert (gw[k] - gb[k]).abs().max() <= 2e-4 * gb[k].abs().max().clamp_min(1e-30), k
    scene = rt_tpu_torch.scene.make_procedural_scene(600)
    target = twf.render_forward_wavefront(scene, size, seed=3, spp=2, max_bounces=4,
                                          gamma=False, device=cuda)
    params = {"materials.albedo": torch.full_like(scene.materials.albedo, 0.5).to(cuda)}
    opt = torch.optim.Adam(list(params.values()), lr=5e-2, foreach=True)
    step = twg.make_wf_train_step(opt, scene, target, size, spp=2, max_bounces=4, device=cuda)
    before = counts()
    losses = [float(step(params, i)) for i in range(4)]
    assert counts() == (before[0] + 16, before[1] + 16)
    assert losses[-1] < losses[0]
    step = ttrain.make_kernel_train_step(opt, scene, target, size, spp=2, max_bounces=4,
                                         device=cuda)
    before = counts()
    step(params, 4)
    assert counts() == before


# ---- the record kernels (queue 2 rows 2 and 6) and the FMA probe (row 10) ----


@pytest.mark.parametrize("name,personality,include_boxes,rng_mode,center", [
    ("basic.toml", "mg", False, "reference", True),
    ("dielectric.toml", "sm", False, "reference", False),
    ("cornell_spheres.toml", "sm", False, "sphere", True),
    ("planes", "mg", False, "reference", False),
    ("box", "mg", True, "reference", True),
    ("proc64", "mg", False, "reference", False),
])
def test_record_kernels_match_plain(cuda, name, personality, include_boxes, rng_mode, center):
    """Both record kernels bit for bit with their plain versions (every
    record array and the radiance), and the radiance equal to the render
    kernel's 1-spp frame at the same seed."""
    from rt_tpu_torch.ops import blockwise as tb

    scene = _scene(name)
    size = (48, 32)
    tabs = tt._unrolled_tables(scene, personality, include_boxes, cuda)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    seeds = torch.tensor([-77], dtype=torch.int32, device=cuda)
    kw = dict(size=size, max_bounces=6, center_sample=center, rng_mode=rng_mode)
    bw_tabs = _bw_tables(cuda, scene, personality, include_boxes)
    before = (tr.render_record_tile.launches, tb.render_record_blockwise_tile.launches)
    runs = [(tr.render_record_tile(*tabs, cam, seeds, **kw),
             tr.render_record_tile_plain(*tabs, cam, seeds, **kw)),
            (tb.render_record_blockwise_tile(*bw_tabs, cam, seeds, **kw),
             tb.render_record_blockwise_tile_plain(*bw_tabs, cam, seeds, **kw))]
    assert (tr.render_record_tile.launches, tb.render_record_blockwise_tile.launches) == (
        before[0] + 1, before[1] + 1)
    frame = tr.render_tile(*tabs, cam, seeds, spp=1, **kw)[0]
    torch.cuda.synchronize()
    for (rad, recs), (want_rad, want) in runs:
        assert torch.equal(rad, want_rad) and torch.equal(rad.reshape(frame.shape), frame)
        for k in want:
            assert torch.equal(recs[k], want[k]), k


@pytest.mark.parametrize("name,personality,include_boxes,center", [
    ("basic.toml", "mg", False, True),
    ("dielectric.toml", "sm", False, False),
    ("box", "mg", True, True),
])
def test_record_kernel_samples_in_one_launch(cuda, name, personality, include_boxes, center):
    """The render kernel's record form traces S samples in one launch: bit
    for bit with its plain version, each sample's slice (records (B, S *
    N), jitter (2, S * N), radiance (S, H, W, 3)) equal to the one-sample
    launch at its seed (sample 0 alone at the centre); and
    records_loss_and_grad launches it once a step."""
    scene = _scene(name)
    size, spp, depth = (37, 23), 4, 6
    n = size[0] * size[1]
    tabs = tt._unrolled_tables(scene, personality, include_boxes, cuda)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    seeds = torch.from_numpy(tg._sample_seeds(-5, spp)).to(cuda)
    kw = dict(size=size, max_bounces=depth)
    before = tr.render_record_tile.launches
    rad, recs = tr.render_record_tile(*tabs, cam, seeds, center_sample=center, **kw)
    assert tr.render_record_tile.launches == before + 1
    want_rad, want = tr.render_record_tile_plain(*tabs, cam, seeds, center_sample=center, **kw)
    ones = [tr.render_record_tile(*tabs, cam, seeds[s:s + 1], center_sample=center and s == 0,
                                  **kw) for s in range(spp)]
    torch.cuda.synchronize()
    assert rad.shape == (spp, size[1], size[0], 3) and recs["jitter"].shape == (2, spp * n)
    assert torch.equal(rad, want_rad) and torch.equal(rad, torch.cat([r for r, _ in ones]))
    for k in want:
        assert recs[k].shape[1] == spp * n, k
        assert torch.equal(recs[k], want[k]), k
        assert torch.equal(recs[k], torch.cat([r[k] for _, r in ones], dim=1)), k

    target = torch.full((size[1], size[0], 3), 0.2, device=cuda)
    before = tr.render_record_tile.launches
    loss, grads = diff.records_loss_and_grad(diff.extract_params(scene), scene, target, size,
                                             seed=3, spp=spp, max_bounces=depth,
                                             personality=personality,
                                             include_boxes=include_boxes, device=cuda)
    torch.cuda.synchronize()
    assert tr.render_record_tile.launches == before + 1
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("name,size,include_boxes", [
    ("box660", (320, 240), True),
    ("box2048", (64, 48), True),
    ("box2100", (64, 48), True),
    ("ties", (96, 64), True),
    ("grazing", (96, 64), False),
])
def test_blockwise_record_kernel_rejecting_scan(cuda, name, size, include_boxes):
    """The blockwise record kernel scans spheres with the rejecting scan,
    keeping the winner's near-root flag (csrc/trace.cuh row_root): bit for
    bit with its plain version (every record array and the radiance), with
    both centre settings, on the 660-sphere + 24-box scene (rows staged in
    shared memory), on 2048 spheres (the most rows staged) and 2100 (rows
    from device memory), each with 24 boxes, and on the tie-heavy and
    grazing scenes."""
    from rt_tpu_torch.ops import blockwise as tb

    scene = rt_tpu_torch.loads({"box660": lambda: box_scene_toml(660, 24),
                                "box2048": lambda: box_scene_toml(2048, 24),
                                "box2100": lambda: box_scene_toml(2100, 24),
                                "ties": tie_scene_toml, "grazing": grazing_scene_toml}[name]())
    tabs = _bw_tables(cuda, scene, "mg", include_boxes)
    cam = torch.from_numpy(tt._pack_camera(scene.camera, size)).to(cuda)
    seeds = torch.tensor([29], dtype=torch.int32, device=cuda)
    for center in (True, False):
        kw = dict(size=size, max_bounces=8, center_sample=center)
        rad, recs = tb.render_record_blockwise_tile(*tabs, cam, seeds, **kw)
        want_rad, want = tb.render_record_blockwise_tile_plain(*tabs, cam, seeds, **kw)
        torch.cuda.synchronize()
        assert torch.equal(rad, want_rad), (name, center)
        for k in want:
            assert torch.equal(recs[k], want[k]), (name, center, k)
        hits = ((recs["bits"] & 16) > 0) & (recs["kind"] == 1)
        assert hits.any() and ((recs["bits"][hits] & 1) > 0).any(), name
        if include_boxes:
            assert (recs["kind"] == 3).any(), name


@pytest.mark.parametrize("k_fma", [64, 1024])
def test_fma_peak_matches_plain(cuda, k_fma):
    from rt_tpu_torch import roofline

    x = torch.full((256, 128), 1.0 + 3e-6, device=cuda)
    x[5, 7] = 0.75
    before = roofline.fma_peak.launches
    got = roofline.fma_peak(x, k_fma)
    assert roofline.fma_peak.launches == before + 1
    want = roofline.fma_peak_plain(x, k_fma)
    torch.cuda.synchronize()
    # the plain version rounds each FMA through float64 (a double rounding
    # that the hardware FMA does not make, in rare halfway cases)
    assert ((got - want).abs() <= 1e-5 * want.abs().clamp_min(1.0)).all()


def test_fma_peak_k_scaling(cuda):
    """The probe's validity check: 4x the chain costs 2.5-6x the time."""
    from rt_tpu_torch import roofline

    tf_1k, dt_1k = roofline.measure_fma_peak(1024)
    tf_4k, dt_4k = roofline.measure_fma_peak(4096)
    assert 2.5 <= dt_4k / dt_1k <= 6.0, (dt_1k, dt_4k)
    assert 1.0 < tf_4k < 200.0


# ---- the jnp-style path (rng, closest_hit, integrator, diff): it runs no
# kernel of its own, so the card is held to the CPU ----

def test_threefry_bits_card_equal_cpu(cuda):
    from rt_tpu_torch import rng

    for seed in (0, -3):
        for chain in ((0,), (3, 1), (7, 2, 5)):
            key = rng.fold(rng.make_key(seed), *chain)
            for fn in (rng.uniform, rng.unit_vector):
                got = fn(key, (65536, 3) if fn is rng.uniform else (65536,), device=cuda)
                want = fn(key, (65536, 3) if fn is rng.uniform else (65536,), device="cpu")
                assert torch.equal(got.cpu(), want), (seed, chain, fn.__name__)


@pytest.mark.parametrize("name,include_boxes", [("box", True), ("cornell_spheres.toml", False),
                                                ("proc500", False), ("ties", True)])
def test_closest_hit_card_matches_cpu(cuda, name, include_boxes):
    from rt_tpu_torch.ops.intersect import closest_hit

    scene = rt_tpu_torch.loads(tie_scene_toml()) if name == "ties" else _scene(name)
    rng = np.random.default_rng(4)
    o = (scene.camera.position.numpy() + rng.normal(size=(1 << 14, 3)) * 1.5).astype(np.float32)
    d = rng.normal(size=(1 << 14, 3)) - [0.0, 0.3, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    want = closest_hit(scene.spheres, scene.planes, scene.boxes, o, d, include_boxes=include_boxes)
    sc = scene.to(cuda)
    got = closest_hit(sc.spheres, sc.planes, sc.boxes, o.to(cuda), d.to(cuda),
                      include_boxes=include_boxes)
    for k in ("kind", "idx", "root_lo", "material", "hit"):
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    assert (got.kind.cpu() > 0).any()
    assert torch.allclose(got.t.cpu(), want.t, rtol=1e-6, atol=0)
    assert torch.allclose(got.normal.cpu(), want.normal, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,personality", [("basic.toml", "mg"), ("dielectric.toml", "sm")])
def test_render_image_card_matches_cpu(cuda, name, personality):
    from rt_tpu_torch import integrator, rng

    scene = _scene(name)
    kw = dict(spp=2, max_bounces=4, personality=personality, ray_chunk=500)
    got = integrator.render_image(scene, (32, 24), rng.make_key(5), device=cuda, **kw)
    want = integrator.render_image(scene, (32, 24), rng.make_key(5), device="cpu", **kw)
    assert got.device.type == "cuda"
    assert_frames_close(got.cpu(), want)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            integrator.render_image(scene, (8, 6), rng.make_key(5), device=cuda, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("grad_mode", ["replay", "autodiff"])
def test_loss_and_grad_card_matches_cpu(cuda, grad_mode):
    from rt_tpu_torch import rng

    scene = _scene("basic.toml")
    target = np.random.default_rng(2).uniform(0, 0.6, (24, 32, 3)).astype(np.float32)
    kw = dict(spp=2, max_bounces=4, grad_mode=grad_mode)
    params = diff.extract_params(scene)
    loss, grads = diff.loss_and_grad({k: v.to(cuda) for k, v in params.items()}, scene, target,
                                     (32, 24), rng.make_key(1), device=cuda, **kw)
    w_loss, w_grads = diff.loss_and_grad(params, scene, target, (32, 24), rng.make_key(1),
                                         device="cpu", **kw)
    assert float(loss) == pytest.approx(float(w_loss), rel=1e-5)
    for k, w in w_grads.items():
        g = grads[k].cpu()
        assert torch.isfinite(g).all(), k
        assert torch.allclose(g, w, rtol=3e-3, atol=3e-4 * max(w.abs().max().item(), 1e-12)), k


def test_profiler_sessions_report_device_events(cuda, tmp_path):
    """``trace`` counts its device events and warns when a trace holds
    none; ``device_times`` raises on a session without device events."""
    import warnings

    from rt_tpu_torch import profiling

    step = tr.make_render_step(_scene("basic.toml"), (64, 48), spp=1, max_bounces=2,
                               device="cuda")
    with warnings.catch_warnings():
        warnings.filterwarnings("error", ".*no device event", RuntimeWarning)
        with profiling.trace(str(tmp_path / "frame")):
            step(seed=0)
    assert profiling.counters["trace.device_events"] > 0
    with pytest.warns(RuntimeWarning, match="no device event"):
        with profiling.trace(str(tmp_path / "nothing")):
            pass
    assert profiling.counters["trace.device_events"] == 0
    with pytest.raises(RuntimeError, match="no device event"):
        profiling.device_times(lambda i: None, iters=2)
    assert any("render_kernel" in k for k in profiling.device_times(lambda i: step(seed=i),
                                                                      iters=2))


def test_spans_share_the_device_clock(cuda, tmp_path):
    """A wavefront frame traced with ``profiling.trace``: every launch of the
    frame lies inside its ``rt.frame`` span, each bounce's kernel starts
    after its ``rt.bounce/<b>`` span opens (the host's spans and the card's
    events on one clock), the trace still counts its device events and
    ``device_times`` its kernels (not the spans' device ranges), and the
    live rays counted on the card are those the benchmark's reference
    traces at the same scene and draws."""
    import json
    from pathlib import Path

    from rt_tpu_torch import profiling
    from rt_tpu_torch import renderer as treg
    from rtbench import inputs
    from rtbench import reference as R
    from rtbench.drive import port_scene

    config = json.loads((Path(__file__).resolve().parent.parent / "rtbench" / "configs"
                         / "cfg5-proc5000.json").read_text())
    config.update(name="small", resolution=[64, 48], samples_per_pixel=2, max_bounces=4)
    config["scene"]["spheres"] = 64
    arrays = inputs.scene_arrays(config)
    scene = port_scene(arrays, config)
    size, kw = (64, 48), dict(seed=12345, spp=2, max_bounces=4, device=cuda)
    render = treg.create("mg_wavefront")
    render(scene, size, **kw)  # the kernel's build, outside the trace
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)) as d:
        render(scene, size, **kw)
    counts = profiling.live_rays()
    [path] = Path(d).glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "ts" in e and "dur" in e]
    host = [e for e in events if e.get("cat") == "user_annotation"]
    [frame] = [e for e in host if e["name"].startswith("rt.frame/")]
    f0, f1 = float(frame["ts"]), float(frame["ts"]) + float(frame["dur"])
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e["name"]]
    assert launches and all(f0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= f1
                            for e in launches)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert device and all(float(e["ts"]) >= f0 for e in device)
    # the spans' ranges on the card are not counted as its work
    assert any(e.get("cat") == "gpu_user_annotation" for e in events)
    assert profiling.counters["trace.device_events"] == len(device)
    assert not any(k.startswith("rt.") for k in
                   profiling.device_times(lambda i: render(scene, size, **kw), iters=2))
    bounces = sorted((e for e in host if e["name"].startswith("rt.bounce/")),
                     key=lambda e: float(e["ts"]))
    kernels = sorted((e for e in device if "wf_gen_kernel" in e["name"]
                      or "wf_bounce_kernel" in e["name"]), key=lambda e: float(e["ts"]))
    assert [e["name"] for e in bounces] == [f"rt.bounce/{b}" for b in range(4)]
    assert len(kernels) == 4
    for b, (s, k) in enumerate(zip(bounces, kernels)):
        assert ("wf_gen_kernel" if b == 0 else "wf_bounce_kernel") in k["name"]
        assert float(k["ts"]) >= float(s["ts"]), b
    cnt = R.new_counts()
    cam = R.camera_vector(arrays["camera_position"], arrays["camera_direction"], size,
                          inputs.VFOV, inputs.NEAR)
    n_pix = size[0] * size[1]
    R.render_sums(R.Tables(arrays, cuda), cam, size, 4, R.frame_plan(12345, 2, n_pix),
                  torch.arange(n_pix, device=cuda), cnt)
    assert counts[0] == n_pix * 2 and sum(counts) == int(cnt["live"])


# ---- rows 5, 7, 8 and 9 with a global offset (the sharded routes) ----


def _offset_inputs(cuda, size):
    scene = rt_tpu_torch.scene.make_procedural_scene(500)
    sp, pl, bx, counts = tt._padded_tables(scene, "mg", False, cuda)
    cam = tt._upload(tt._pack_camera(scene.camera, size), cuda)
    return sp, pl, bx, counts, cam, torch.tensor([7], dtype=torch.int32, device=cuda)


# 101 x 37 = 3737 pixels: a shard that starts mid-warp, one whose tail is padding
@pytest.mark.parametrize("pix0,count", [(45, 1000), (3000, 1000)])
def test_blockwise_kernels_with_offset_match_plain(cuda, pix0, count):
    """Rows 5 and 7 on a shard of the frame: the forward (4 samples, and the
    words form) bit for bit with its plain version at the same offset and
    with the whole frame's pixels, the padding zero and the miss word; the
    gradient within 1e-5 x L1."""
    from rt_tpu_torch.ops import blockwise as tbw
    from rt_tpu_torch.ops import blockwise_grad as tbg

    size = (101, 37)
    n = size[0] * size[1]
    inside = min(n, pix0 + count) - pix0
    sp, pl, bx, counts, cam, seeds = _offset_inputs(cuda, size)
    kw = dict(size=size, max_bounces=8, center_sample=False)
    got = tbw.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=4, pix0=pix0,
                                    count=count, **kw)
    want = tbw.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=4, pix0=pix0,
                                           count=count, **kw)
    whole = tbw.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=4, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[:inside], whole.reshape(n, 3)[pix0:pix0 + inside])
    assert not got[inside:].any()
    frame, words = tbw.render_blockwise_tile(sp, pl, bx, counts, cam, seeds, spp=1, words=True,
                                             pix0=pix0, count=count, **kw)
    p_frame, p_words = tbw.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1,
                                                       words=True, pix0=pix0, count=count, **kw)
    torch.cuda.synchronize()
    assert torch.equal(frame, p_frame) and torch.equal(words, p_words)
    assert (words[:, inside:] == tr.WORD_MISS).all()
    cot = torch.from_numpy(np.random.default_rng(3).normal(0, 1e-3, (count, 3))
                           .astype(np.float32)).to(cuda)
    cot[inside:] = 0
    got = tbg.bw_grad_tile(sp, pl, counts[:2], cam, seeds, cot, words, pix0=pix0, count=count,
                           **kw)
    want, l1 = tbg.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot, words, pix0=pix0,
                                      count=count, with_l1=True, **kw)
    torch.cuda.synchronize()
    _assert_within_l1(got, want, l1)


@pytest.mark.parametrize("ray0,rays", [(45, 3000), (5000, 3000)])
def test_wavefront_kernels_with_offset_match_plain(cuda, ray0, rays):
    """Rows 8 and 9 on a shard of a 2-sample chunk of 7474 rays (a start
    mid-warp; a padded tail): the gen launch and bounce 1 bit for bit with
    their plain versions at the same offset, the reverse of both within
    1e-5 x L1 and its cotangent table (by id - ray0) close."""
    from rt_tpu_torch.ops import wavefront as twf
    from rt_tpu_torch.ops import wavefront_grad as twg

    size = (101, 37)
    total = 2 * size[0] * size[1]
    sp, pl, bx, counts, cam, seeds = _offset_inputs(cuda, size)
    kw = dict(size=size, max_bounces=8)
    st = torch.empty((13, rays), device=cuda)
    ids = torch.empty(rays, dtype=torch.int32, device=cuda)
    st_p, ids_p = st.clone(), ids.clone()
    w0 = twf.wf_bounce(sp, pl, bx, counts, cam, seeds, st, ids, bounce=0, center_sample=True,
                       record=True, ray0=ray0, total=total, **kw)
    w0_p = twf.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st_p, ids_p, bounce=0,
                               center_sample=True, record=True, ray0=ray0, total=total, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st, st_p) and torch.equal(ids, ids_p) and torch.equal(w0, w0_p)
    entering = st.clone()
    w1 = twf.wf_bounce(sp, pl, bx, counts, cam, seeds, st, ids, bounce=1, record=True, **kw)
    w1_p = twf.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st_p, ids_p, bounce=1,
                               record=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st, st_p) and torch.equal(w1, w1_p)
    cot_pix = torch.from_numpy(np.random.default_rng(6).uniform(-1e-4, 1e-4, (total // 2, 3))
                               .astype(np.float32)).to(cuda)
    cot = torch.from_numpy(np.random.default_rng(7).uniform(-1e-4, 1e-4, (9, rays))
                           .astype(np.float32)).to(cuda)
    for b, state, words in ((1, entering, w1), (0, None, w0)):
        cot_plain = cot.clone()
        rk = dict(bounce=b, center_sample=True, ray0=ray0, total=total, **kw)
        got = twg.wf_rev(sp, pl, counts[:2], cam, seeds, state, ids, words, None, cot, cot_pix,
                         **rk)
        want, l1 = twg.wf_rev_plain(sp, pl, counts[:2], cam, seeds, state, ids, words, None,
                                    cot_plain, cot_pix, with_l1=True, **rk)
        torch.cuda.synchronize()
        _assert_within_l1(got, want, l1)
        assert (cot - cot_plain).abs().max() <= 1e-5 * cot_plain.abs().max().clamp_min(1e-30)
        cot = cot_plain


def test_sharded_blockwise_in_a_one_rank_world(cuda):
    """A 1-rank NCCL world on the card: the sharded blockwise frame is the
    unsharded one, bit for bit."""
    import torch.distributed as tdist

    from rt_tpu_torch import dist
    from rt_tpu_torch.ops import blockwise as tbw

    scene = rt_tpu_torch.scene.make_procedural_scene(300)
    dist.initialize(init_method=f"tcp://127.0.0.1:{dist._free_port()}", world_size=1, rank=0)
    try:
        mesh = dist.make_mesh(1, 1)
        got = tbw.render_forward_blockwise_sharded(scene, (97, 41), mesh, 3, spp=4,
                                                   max_bounces=6)
        want = tbw.render_forward_blockwise(scene, (97, 41), 3, spp=4, max_bounces=6)
        torch.cuda.synchronize()
        assert tdist.get_backend() == "nccl"
        assert torch.equal(got, want)
    finally:
        tdist.destroy_process_group()
