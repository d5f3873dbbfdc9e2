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


# ---- the split scan of the later bounces (csrc/wavefront_kernel.cu) ----

_NONE, _PLANE, _SPHERE, _BOX = 0, 1, 2, 3  # trace.cuh's Kind
_NO_HIT = float("inf")


def _serial_winner(tp, ts, tb, first=0, step=1):
    """trace.cuh closest_hit's rule over rows first, first + step, ... of
    each class: planes with strict '<', then spheres (a sphere wins a tie
    against a plane), then boxes with strict '<'.  ``tp``, ``ts``, ``tb``:
    (sets, rows) float32 distances of the rows that are hit, inf where a
    row is not.  Returns (best, kind, row) per set."""
    n = tp.shape[0]
    best = torch.full((n,), 3.0e38)
    kind = torch.full((n,), _NONE, dtype=torch.int64)
    win = torch.zeros(n, dtype=torch.int64)
    for cls, tab in ((_PLANE, tp), (_SPHERE, ts), (_BOX, tb)):
        for r in range(first, tab.shape[1], step):
            t = tab[:, r]
            ok = t < best
            if cls == _SPHERE:
                ok = ok | ((t == best) & (kind == _PLANE))
            best = torch.where(ok, t, best)
            kind = torch.where(ok, cls, kind)
            win = torch.where(ok, r, win)
    return best, kind, win


def _rank(kind):
    # hit_rank: sphere 0, plane 1, box 2, none 3
    return torch.where(kind == _SPHERE, 0, torch.where(kind == _PLANE, 1,
                                                       torch.where(kind == _BOX, 2, 3)))


def _merged_winner(tp, ts, tb, g):
    """The split scan of wf_bounce_kernel for a group of ``g`` lanes: lane k
    scans rows k, k + g, ... (closest_hit with first k, step g), then
    merge_hit's shuffle butterfly on the key (t, rank, row).  A torch
    mirror of csrc/wavefront_kernel.cu merge_hit.  Returns every lane's
    (best, kind, row), (g, sets) each."""
    lanes = [_serial_winner(tp, ts, tb, k, g) for k in range(g)]
    best, kind, win = (torch.stack(v) for v in zip(*lanes))
    lane = torch.arange(g)
    off = g >> 1
    while off:
        ob, ok, ow = best[lane ^ off], kind[lane ^ off], win[lane ^ off]
        r, orank = _rank(kind), _rank(ok)
        take = (ob < best) | ((ob == best) & ((orank < r) | ((orank == r) & (ow < win))))
        best, kind, win = (torch.where(take, o, v) for o, v in ((ob, best), (ok, kind),
                                                               (ow, win)))
        off >>= 1
    return best, kind, win


def _candidate_sets(rng, sets, rows, levels):
    """Distances drawn from a few levels (so that ties across classes and
    rows are common), a third of the rows not hit."""
    t = rng.choice(np.asarray(levels, np.float32), size=(sets, rows))
    t[rng.random((sets, rows)) < 0.33] = _NO_HIT
    return torch.from_numpy(t)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_split_scan_merge_is_the_serial_winner(g):
    """The lanes' merged winner equals the serial scan's on every set, and
    every lane of the group holds it: the smallest t, a sphere before a
    plane before a box at one t (a box never wins a tie), the first row of
    a class."""
    rng = np.random.default_rng(g)
    levels = (0.5, 1.0, 1.0000001, 2.0)
    cases = [(_candidate_sets(rng, 400, rows_p, levels), _candidate_sets(rng, 400, rows_s, levels),
              _candidate_sets(rng, 400, rows_b, levels))
             for rows_p, rows_s, rows_b in ((3, 45, 7), (1, 70, 0), (0, 33, 40), (5, 0, 9))]
    # duplicated rows: every sphere row at one t, the same t in a plane and
    # a box, rows repeated across the table; nothing hit at all
    dup = torch.full((1, 64), 1.5)
    cases += [(torch.tensor([[1.5, 1.5]]), dup, torch.tensor([[1.5, 1.5, 1.5]])),
              (torch.tensor([[1.5]]), torch.full((1, 40), _NO_HIT), torch.tensor([[9.0, 1.5]])),
              (torch.zeros((1, 0)), torch.cat([dup[:, :20] + 1, dup[:, :20]], 1),
               torch.zeros((1, 0))),
              (torch.full((1, 4), _NO_HIT), torch.full((1, 50), _NO_HIT),
               torch.full((1, 6), _NO_HIT))]
    kinds = set()
    for tp, ts, tb in cases:
        want = _serial_winner(tp, ts, tb)
        got = _merged_winner(tp, ts, tb, g)
        for lane in range(g):
            for a, b in zip(got, want):
                assert torch.equal(a[lane], b)
        kinds.update(want[1].tolist())
    assert kinds == {_NONE, _PLANE, _SPHERE, _BOX}
