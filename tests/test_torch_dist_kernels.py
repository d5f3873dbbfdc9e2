"""The four sharded kernel routes on the CPU (the kernels' plain versions):
rows 5, 7, 8 and 9 of the kernel table with a global pixel or ray offset,
``render_forward_blockwise_sharded``, ``render_forward_wavefront_sharded``
and the sharded blockwise and wavefront train steps.

* In-process, no world: each plain version with an offset against the
  same pixels or rays of the whole-range call.  The forward ones (rows 5
  and 8) and row 9's per-ray cotangent table are equal bit for bit; the
  gradient sums (rows 7 and 9) are the whole call's within float rounding
  (1e-6 of each entry's L1), summed over the shards that cover the range:
  a sum over other pixels is taken in another order.
* A Gloo world of 4 ranks (one for the file, ``torch_dist_ranks.kernels_rank``,
  one torch thread a rank), each route sharded over 4 ranks ((4, 1)) and
  over 2 (the 'rays' axis of (2, 2)): every frame equal to the unsharded
  route's bit for bit, a ragged 37x23 frame (the last shard padded),
  ``--boxes`` and a live-prefix shrink that cuts the ranks' tables, and a
  wavefront chunk cap that binds (the cap lowered to 1000 rays: the global
  cap, so the chunking is the unsharded route's); one Adam step of each
  train step against the unmeshed step (loss within 1e-6, params within
  1e-6, as tests/test_pallas_blockwise_grad.py:194-219 holds JAX's); and
  the blockwise step against JAX's ``make_bw_train_step(mesh=...)`` on 2
  virtual devices (``rng_impl="hash", interpret=True``), with
  test_torch_blockwise_train.py's tolerances.

The unsharded kernel routes are held against JAX by their own files.
JAX's interpret-mode sharded wavefront takes 450 s in its own test, so the
sharded wavefront is held against the port's unsharded route only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rt_tpu
import rt_tpu_torch
import torch_dist_ranks as R
from rt_tpu import diff as jdiff
from rt_tpu import dist as jdist
from rt_tpu.ops import pallas_blockwise_grad as PBG
from rt_tpu_torch import dist
from rt_tpu_torch.ops import blockwise as BW
from rt_tpu_torch.ops import blockwise_grad as BG
from rt_tpu_torch.ops import wavefront as WF
from rt_tpu_torch.ops import wavefront_grad as WG
from rt_tpu_torch.ops.render import WORD_MISS
from rt_tpu_torch.ops.tables import _pack_camera, _padded_tables, _upload

SIZE = (37, 23)  # 851 pixels
N = SIZE[0] * SIZE[1]
# (first, count): the whole range, a start mid-warp, a padded tail
SPANS = [(0, N), (45, 300), (700, 256)]
DEPTH = 4
# the blockwise step of the comparison with JAX
JAX_CASE = dict(n_spheres=24, size=(32, 24), spp=1, max_bounces=2)


@pytest.fixture(scope="module")
def inputs():
    s = rt_tpu_torch.scene.make_procedural_scene(60)
    sp, pl, bx, counts = _padded_tables(s, "mg", False, torch.device("cpu"))
    cam = _upload(_pack_camera(s.camera, SIZE), torch.device("cpu"))
    return sp, pl, bx, counts, cam, torch.tensor([9], dtype=torch.int32)


@pytest.fixture(scope="module")
def world():
    target = torch.from_numpy(np.random.default_rng(0).uniform(0.0, 0.5, (24, 32, 3))
                              .astype(np.float32))
    return dist.run_local(R.kernels_rank, 4, dict(JAX_CASE, target=target), device="cpu",
                          threads=1, timeout=120, collective_timeout=60)


def _close(got, want, l1):
    for g, w, m in zip(got, want, l1):
        assert (torch.as_tensor(g).double() - w.double()).abs().le(1e-6 * m.double() + 1e-30).all()


@pytest.mark.parametrize("pix0,count", SPANS)
def test_blockwise_plain_offset(inputs, pix0, count):
    sp, pl, bx, counts, cam, seeds = inputs
    kw = dict(size=SIZE, max_bounces=DEPTH, center_sample=True)
    whole = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=2, **kw)
    got = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=2, pix0=pix0,
                                         count=count, **kw)
    inside = min(N, pix0 + count) - pix0
    assert got.shape == (count, 3)
    assert torch.equal(got[:inside], whole.reshape(N, 3)[pix0:pix0 + inside])
    assert not got[inside:].any()
    w_frame, w_words = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1,
                                                      words=True, **kw)
    frame, words = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1,
                                                  words=True, pix0=pix0, count=count, **kw)
    assert words.shape == (DEPTH, count)
    assert torch.equal(frame[:inside], w_frame.reshape(N, 3)[pix0:pix0 + inside])
    assert torch.equal(words[:, :inside], w_words[:, pix0:pix0 + inside])
    assert (words[:, inside:] == WORD_MISS).all()


def test_bw_grad_plain_offset_shards_sum_to_the_whole(inputs):
    sp, pl, bx, counts, cam, seeds = inputs
    kw = dict(size=SIZE, max_bounces=DEPTH, center_sample=False)
    _, words = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1, words=True,
                                             **kw)
    cot = torch.from_numpy(np.random.default_rng(1).normal(0, 1e-3, (SIZE[1], SIZE[0], 3))
                           .astype(np.float32))
    want, l1 = BG.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, cot, words, with_l1=True,
                                     **kw)
    total = None
    for pix0, count in ((0, 300), (300, 300), (600, 300)):  # the last shard padded
        _, wd = BW.render_blockwise_tile_plain(sp, pl, bx, counts, cam, seeds, spp=1,
                                               words=True, pix0=pix0, count=count, **kw)
        c = torch.zeros((count, 3))
        inside = min(N, pix0 + count) - pix0
        c[:inside] = cot.reshape(N, 3)[pix0:pix0 + inside]
        got = BG.bw_grad_tile_plain(sp, pl, counts[:2], cam, seeds, c, wd, pix0=pix0,
                                    count=count, **kw)
        total = got if total is None else tuple(a + b for a, b in zip(total, got))
    _close(total, want, l1)


@pytest.mark.parametrize("ray0,rays", [(0, 2 * N), (45, 700), (1500, 512)])
def test_wavefront_plain_offset(inputs, ray0, rays):
    sp, pl, bx, counts, cam, seeds = inputs
    total = 2 * N
    kw = dict(size=SIZE, max_bounces=DEPTH)
    ws, wi = torch.empty((13, total)), torch.empty(total, dtype=torch.int32)
    w_words = WF.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, ws, wi, bounce=0,
                                 center_sample=True, record=True, **kw)
    st, ids = torch.empty((13, rays)), torch.empty(rays, dtype=torch.int32)
    words = WF.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st, ids, bounce=0,
                               center_sample=True, record=True, ray0=ray0, total=total, **kw)
    inside = min(total, ray0 + rays) - ray0
    cols = slice(ray0, ray0 + inside)
    assert torch.equal(ids, torch.arange(ray0, ray0 + rays, dtype=torch.int32))
    assert torch.equal(st[:, :inside], ws[:, cols]) and torch.equal(words[:inside], w_words[cols])
    assert not st[:, inside:].any() and (words[inside:] == WORD_MISS).all()
    # a later bounce of the shard's rays is the whole chunk's, ray by ray
    w_b1 = WF.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, ws, wi, bounce=1, record=True, **kw)
    b1 = WF.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st, ids, bounce=1, record=True, **kw)
    assert torch.equal(st[:, :inside], ws[:, cols]) and torch.equal(b1[:inside], w_b1[cols])


def _wf_record(inputs, ray0, rays, total):
    """Bounces 0 and 1 of the rays ``ray0 ..`` of a chunk of ``total``:
    ``(ids, words0, state entering bounce 1, words1)``."""
    sp, pl, bx, counts, cam, seeds = inputs
    kw = dict(size=SIZE, max_bounces=DEPTH, record=True)
    st, ids = torch.empty((13, rays)), torch.empty(rays, dtype=torch.int32)
    w0 = WF.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st, ids, bounce=0,
                            center_sample=True, ray0=ray0, total=total, **kw)
    entering = st.clone()
    w1 = WF.wf_bounce_plain(sp, pl, bx, counts, cam, seeds, st, ids, bounce=1, **kw)
    return ids, w0, entering, w1


def test_wf_rev_plain_offset_shards_sum_to_the_whole(inputs):
    """The reverse of bounces 1 and 0 over three shards of a 2-sample chunk
    (the last padded): each shard's cotangent table (by id - ray0) is the
    whole chunk's columns bit for bit, and the shards' gradients sum to the
    whole chunk's."""
    sp, pl, bx, counts, cam, seeds = inputs
    total = 2 * N
    kw = dict(size=SIZE, max_bounces=DEPTH, center_sample=True)
    cot_pix = torch.from_numpy(np.random.default_rng(2).normal(0, 1e-3, (N, 3))
                               .astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(3).normal(0, 1e-3, (9, 3 * 600))
                         .astype(np.float32))

    def reverse(ray0, rays, tot, cot, l1=False):
        ids, w0, entering, w1 = _wf_record(inputs, ray0, rays, tot)
        extra = dict(with_l1=True) if l1 else dict(ray0=ray0, total=tot)
        r1 = WG.wf_rev_plain(sp, pl, counts[:2], cam, seeds, entering, ids, w1, None, cot,
                             cot_pix, bounce=1, **kw, **extra)
        r0 = WG.wf_rev_plain(sp, pl, counts[:2], cam, seeds, None, None, w0, None, cot, cot_pix,
                             bounce=0, **kw, **extra)
        if l1:
            return tuple(a + b for a, b in zip(r1[0], r0[0])), tuple(
                a + b for a, b in zip(r1[1], r0[1]))
        return tuple(a + b for a, b in zip(r1, r0))

    w_cot = g[:, :total].clone()
    want, l1 = reverse(0, total, total, w_cot, l1=True)
    got = None
    for ray0 in (0, 600, 1200):
        cot = g[:, ray0:ray0 + 600].clone()
        part = reverse(ray0, 600, total, cot)
        inside = min(total, ray0 + 600) - ray0
        assert torch.equal(cot[:, :inside], w_cot[:, ray0:ray0 + inside])
        got = part if got is None else tuple(a + b for a, b in zip(got, part))
    _close(got, want, l1)


def test_every_rank_agrees(world):
    for r in world[1:]:
        for k in r:
            if k != "jax_case" and isinstance(r[k], torch.Tensor):
                assert torch.equal(r[k], world[0][k]), k


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("case", R.FRAMES, ids=[c[0] for c in R.FRAMES])
def test_sharded_frame_is_the_unsharded_frame(world, case, shape):
    want = R.kernel_frame(case)
    assert torch.equal(world[0][(case[0], shape)], want)
    if case[0] == "wf capped":  # the cap binds: another chunking than without it
        assert not torch.equal(want, R.kernel_frame(case[:5] + ({},)))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("route", ["bw", "wf"])
def test_sharded_train_step_is_the_unmeshed_step(world, route, shape):
    loss, params = world[0][(route, shape)]
    want_loss, want = R.kernel_step(route)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    for k in want:
        np.testing.assert_allclose(params[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_sharded_bw_step_matches_jax(world):
    c = dict(JAX_CASE)
    js = rt_tpu.scene.make_procedural_scene(c.pop("n_spheres"))
    size = c.pop("size")
    target = np.random.default_rng(0).uniform(0.0, 0.5, (24, 32, 3)).astype(np.float32)
    opt = optax.adam(R.STEP["lr"])
    step = PBG.make_bw_train_step(opt, js, jnp.asarray(target), size, rng_impl="hash",
                                  interpret=True,
                                  mesh=jdist.make_mesh(2, 1, devices=jax.devices()[:2]), **c)
    params = jdiff.extract_params(js)
    params, _, want_loss = step(params, opt.init(params), R.STEP["seed"])
    loss, got = world[0]["jax_case"]
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    # test_torch_blockwise_train.py: Adam moves each param by about lr, so
    # the gradients' agreement bounds the params' to ~3e-4
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(params[k]), rtol=1e-6, atol=3e-4,
                                   err_msg=k)
