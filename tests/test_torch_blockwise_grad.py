"""The blockwise fused step's plain PyTorch path against the JAX blockwise
pipeline (``bw_mse_loss_and_grad(rng_impl="hash", interpret=True)``) on
basic.toml, on a plane scene (the plane branch of the scan and of the
adjoint, and the plane material slots) and on dielectric.toml (sm).  The
port's step takes each gradient launch's winners from the forward launch's
winner words (``render_blockwise_tile(words=True)``, then
``bw_grad_tile_plain`` over them), where JAX's gradient kernel scans again;
and the forward's words are the gradient sweep's own scan winners."""

import numpy as np
import pytest
import torch

import rt_tpu_torch
from rt_tpu_torch.ops import _grad_math as gm
from rt_tpu_torch.ops import blockwise as tb
from rt_tpu_torch.ops import render as tr
from test_torch_common import SCENES
from test_torch_grad_mono import assert_step_matches_jax


@pytest.mark.parametrize("name,personality,seed", [("basic.toml", "mg", 3), ("planes", "mg", 9),
                                                    ("dielectric.toml", "sm", 5)])
def test_bw_step_matches_jax(name, personality, seed):
    assert_step_matches_jax(name, personality, "blockwise", spp=2, seed=seed)


@pytest.mark.parametrize("name,seed,center", [("dielectric.toml", 4, True),
                                              ("cornell_spheres.toml", 8, False)])
def test_forward_words_are_the_gradient_sweeps_winners(name, seed, center):
    """Along the gradient sweep (``_grad_math``'s scan and
    ``_bounce_forward``, whose dielectric clamps cos_t at 1e-12 where the
    render bounce clamps at 0), the forward's word of every bounce is the
    scan's winner on every live ray, and ``replay_winner`` recomputes the
    scan's distance, row, plane flag and root bit from it.  The two sweeps
    could part only on a refraction with sin2 == 1.0f exactly; the count of
    those is 0 on these inputs (reported in the assertion)."""
    scene = rt_tpu_torch.load(str(SCENES / name))
    size, depth = (40, 30), 8
    w, h = size
    n = w * h
    sp, pl, bx, counts = tb._device_tables(scene, "sm", False, torch.device("cpu"))
    cam = torch.from_numpy(tr._pack_camera(scene.camera, size))
    _, words = tb.render_blockwise_tile_plain(sp, pl, bx, counts, cam,
                                              torch.tensor([seed], dtype=torch.int32), size=size,
                                              spp=1, max_bounces=depth, center_sample=center,
                                              words=True)
    spheres, planes = sp[:counts[0], :10], pl[:counts[1], :10]
    idx = torch.arange(n)
    jx, jy = (0.5, 0.5) if center else (tr.hash_u01(idx, seed, 1), tr.hash_u01(idx, seed, 2))
    o3, d3 = gm.raygen(cam.tolist(), (idx % w).float(), (idx // w).float(), jx, jy,
                       *tr._inv_size(w, h))
    thr3 = (torch.ones(n),) * 3
    live = torch.ones(n, dtype=torch.bool)
    checked = refractions = sin2_one = 0
    for b in range(depth):
        u3 = gm.unit_draws(idx, seed, 3 + 4 * b, False)
        coin = tr.hash_u01(idx, seed, 6 + 4 * b)
        best, bidx, ispl, root = gm.scan(spheres, planes, o3, d3)
        want = torch.where(best < 1e37, bidx | (ispl.long() << 24), tr.WORD_MISS)
        assert torch.equal(words[b][live].long(), want[live]), b
        assert (words[b][~live] == tr.WORD_MISS).all(), b
        again = gm.replay_winner(spheres, planes, o3, d3, words[b])
        for a, v in zip(again, (best, bidx, ispl, root)):
            assert torch.equal(a[live], v[live]), b
        pay, cls = gm.payload(spheres, planes, best < 1e37, ispl, bidx)
        bits, geo = gm._decide(o3, d3, live, best, pay, cls, ispl, root, u3, coin)
        refract = bits["live_h"] & bits["is_die"] & ~bits["refl"]
        refractions += int(refract.sum())
        sin2_one += int((refract & (geo["sin2"] == 1.0)).sum())
        checked += int(live.sum())
        o3, d3, thr3, _, bits = gm.bounce_forward(o3, d3, thr3, best, pay, cls, ispl, root, live,
                                                  u3, coin)
        live = bits["alive"]
    assert checked > n and refractions > 0
    assert sin2_one == 0, f"{sin2_one} refractions with sin2 == 1 of {refractions}"
