"""The reference against the program's plain PyTorch versions on the CPU,
at tiny frames of both configurations' scenes: the inputs, the camera,
every draw plan, the frame bit for bit, the loss and the gradient.  The
test imports the program; the reference does not."""

import numpy as np
import pytest
import torch

from rtbench import inputs
from rtbench import reference as R

SIZE, SPP, DEPTH = (32, 24), 2, 4


@pytest.mark.parametrize("n", [24, 700])
def test_scene_is_the_programs(n):
    from rt_tpu_torch.scene import make_procedural_scene

    a = inputs.procedural_scene(n, 0)
    sc = make_procedural_scene(n, seed=0)
    for key, t in (("center", sc.spheres.center), ("radius", sc.spheres.radius),
                   ("material", sc.spheres.material), ("albedo", sc.materials.albedo),
                   ("roughness", sc.materials.roughness),
                   ("reflectivity", sc.materials.reflectivity), ("mat_type", sc.materials.type)):
        assert np.array_equal(a[key], t.numpy()), key


@pytest.mark.parametrize("size", [(32, 24), (1920, 1080), (960, 540)])
def test_camera_vector_is_the_programs(size):
    from rt_tpu_torch.ops.render import _pack_camera
    from rt_tpu_torch.scene import make_procedural_scene

    a = inputs.procedural_scene(8, 0)
    got = np.asarray(R.camera_vector(a["camera_position"], a["camera_direction"], size,
                                     inputs.VFOV, inputs.NEAR), np.float32)
    assert np.array_equal(got, _pack_camera(make_procedural_scene(8).camera, size))


def test_seed_chains_are_the_programs():
    from rt_tpu_torch.ops.grad import _sample_seeds
    from rt_tpu_torch.ops.render import _chunk_seeds
    from rt_tpu_torch.ops.wavefront_grad import _train_seeds

    for seed in (0, 7, 2**31 - 2, 1_234_567_890):
        assert R.frame_chunk_seeds(seed, 5) == _chunk_seeds(seed, 5)[:, 0].tolist()
        assert [s[0][0] for s in R.per_sample_plan(seed, 6, 10)] == _sample_seeds(seed, 6).tolist()
        assert R.train_chunk_seeds(seed, 5) == _train_seeds(seed, 5).tolist()


def test_hash_is_the_programs():
    from rt_tpu_torch.ops.render import hash_u01

    pix = torch.arange(0, 5000, 7, dtype=torch.int64)
    for seed, ctr in ((0, 0), (2**31 - 1, 33), (-5, 1000)):
        assert torch.equal(R.hash_u01(pix, seed, ctr), hash_u01(pix, seed, ctr))


@pytest.mark.parametrize("n", [24, 60])
@pytest.mark.parametrize("seed", [5, 2_000_000_011])
def test_frame_bit_for_bit(n, seed):
    """Every pixel of the frame as the megakernel route's plain version
    returns it, and the live work counted."""
    from rt_tpu_torch.ops.render import render_forward
    from rt_tpu_torch.scene import make_procedural_scene

    a = inputs.procedural_scene(n, 0)
    tab = R.Tables(a, "cpu")
    cam = R.camera_vector(a["camera_position"], a["camera_direction"], SIZE, inputs.VFOV,
                          inputs.NEAR)
    port = render_forward(make_procedural_scene(n), SIZE, seed, spp=SPP, max_bounces=DEPTH,
                          device="cpu").reshape(-1, 3)
    counts = R.new_counts()
    ref = R.frame_pixels(tab, cam, SIZE, SPP, DEPTH, seed, torch.arange(SIZE[0] * SIZE[1]),
                         counts)
    assert torch.equal(port, ref)
    assert counts["rays"] == SIZE[0] * SIZE[1] * SPP
    assert int(counts["live"]) == int(counts["miss"]) + int(counts["sphere"])
    assert int(counts["sphere"]) == int(counts["lambert"]) + int(counts["metal"])
    assert int(counts["disc_pairs"]) >= int(counts["sphere"])


def test_frame_pixel_sample_is_the_frames_pixels():
    a = inputs.procedural_scene(24, 0)
    tab = R.Tables(a, "cpu")
    cam = R.camera_vector(a["camera_position"], a["camera_direction"], SIZE, inputs.VFOV,
                          inputs.NEAR)
    full = R.frame_pixels(tab, cam, SIZE, SPP, DEPTH, 9, torch.arange(SIZE[0] * SIZE[1]))
    pix = inputs.pixel_sample(SIZE[0] * SIZE[1], 100, 3)
    assert torch.equal(R.frame_pixels(tab, cam, SIZE, SPP, DEPTH, 9, pix), full[pix])


@pytest.mark.parametrize("route,plan", [("bw", "per_sample"), ("wf", "chunked")])
def test_loss_and_gradient(route, plan):
    """The training routes' loss and albedo gradient at their own draws."""
    from rt_tpu_torch.ops.blockwise_grad import bw_mse_loss_and_grad
    from rt_tpu_torch.ops.wavefront_grad import wf_mse_loss_and_grad
    from rt_tpu_torch.scene import make_procedural_scene

    fn = {"bw": bw_mse_loss_and_grad, "wf": wf_mse_loss_and_grad}[route]
    a = inputs.procedural_scene(24, 0)
    tgt = inputs.target_image(SIZE, 3, "cpu")
    alb = torch.rand((16, 4), generator=torch.Generator().manual_seed(1)) * 0.8 + 0.1
    loss, grads = fn({"materials.albedo": alb}, make_procedural_scene(24), tgt, SIZE, 77,
                     spp=SPP, max_bounces=DEPTH, device="cpu")
    tab = R.Tables(a, "cpu", albedo=alb.numpy())
    cam = R.camera_vector(a["camera_position"], a["camera_direction"], SIZE, inputs.VFOV,
                          inputs.NEAR)
    l2, g2 = R.loss_and_grad(tab, cam, SIZE, SPP, DEPTH,
                             R.STEP_PLANS[plan](77, SPP, SIZE[0] * SIZE[1]), tgt)
    g = grads["materials.albedo"].double()
    assert abs(float(loss) / l2 - 1.0) < 1e-6
    assert float((g[:, :3] - g2).abs().max()) < 1e-6 * float(g2.abs().max())
    assert float(g[:, 3].abs().max()) == 0.0
    # the other plan draws other rays: its loss differs far more
    other = R.STEP_PLANS["chunked" if plan == "per_sample" else "per_sample"]
    l3, _ = R.loss_and_grad(tab, cam, SIZE, SPP, DEPTH, other(77, SPP, SIZE[0] * SIZE[1]), tgt)
    assert abs(l3 / l2 - 1.0) > 1e-4


def test_adam_is_torchs():
    p = torch.rand(16, 4, dtype=torch.float64)
    q = p.clone().requires_grad_(False)
    opt = torch.optim.Adam([p], lr=5e-2)
    m, v = torch.zeros_like(q), torch.zeros_like(q)
    for k in range(1, 4):
        g = torch.randn(16, 4, dtype=torch.float64)
        p.grad = g.clone()
        opt.step()
        R.adam_update(q, g, m, v, k, 5e-2)
    assert torch.allclose(p, q, rtol=0, atol=1e-12)
