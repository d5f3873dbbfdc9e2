"""The port's tools and examples on the CPU: ``rt_tpu_torch.render_4k``
(the route and chunk it reports, its frame against
``render_forward_blockwise``, and where it writes) and ``rt_tpu_torch.examples``' two single-process
examples at tiny sizes.  The examples' functions are held against JAX in
their own test files; JAX's interpret-mode examples are not re-run here."""

import os

import numpy as np
import pytest
import torch

import rt_tpu_torch
from rt_tpu_torch import render_4k
from rt_tpu_torch.colour import pack_rgba8888
from rt_tpu_torch.examples import big_scene_training, inverse_rendering
from rt_tpu_torch.ops.blockwise import render_forward_blockwise
from rt_tpu_torch.ops.wavefront import _resolve_chunk
from test_torch_common import SCENES, read_png

REPO = SCENES.parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small eager ops, which gain nothing from
    intra-op threads; one thread keeps them from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_render_4k_chunk_at_3840x2160():
    # the JAX tool's wavefront chunk, 2^25 rays: 4 of its --spp-chunk 8's
    # samples at 3840x2160, the blockwise route's 4 (so the two draw alike)
    assert _resolve_chunk((3840, 2160), 256, 8) == 4
    scene = rt_tpu_torch.scene.make_procedural_scene(render_4k.SPHERES)
    assert rt_tpu_torch.renderer.auto_route(scene, "cuda") == "blockwise"
    assert render_4k.frame_bytes(3840 * 2160) < 80 * 2**30
    assert not os.path.abspath(render_4k.default_out()).startswith(str(REPO))


def test_default_outputs_follow_the_temporary_directory(monkeypatch, tmp_path):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert render_4k.default_out() == str(tmp_path / "rt_tpu_torch_config5_4k.png")
    seen = {}  # inverse_rendering's parsed arguments; it stops there
    real_parse = inverse_rendering.argparse.ArgumentParser.parse_args

    def parse(self, argv=None, namespace=None):
        args = real_parse(self, argv, namespace)
        seen["out"] = args.out
        raise SystemExit(0)

    monkeypatch.setattr(inverse_rendering.argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(SystemExit):
        inverse_rendering.main([])
    assert seen["out"] == str(tmp_path / "inverse_demo_torch")


def test_render_4k_tiny_frame(tmp_path, capsys):
    docs = REPO / "docs" / "config5_4k_preview.png"
    docs_before = docs.stat().st_mtime_ns if docs.exists() else None
    default = render_4k.default_out()
    default_before = os.stat(default).st_mtime_ns if os.path.exists(default) else None
    out = tmp_path / "frame.png"
    img = render_4k.main(["--size", "32x18", "--spp", "2", "--device", "cpu", "--out", str(out)])
    text = capsys.readouterr().out
    assert "32x18 @2spp d8, 5000 spheres: the blockwise route, 2 samples a chunk" in text
    scene = rt_tpu_torch.scene.make_procedural_scene(5000)
    want = render_forward_blockwise(scene, (32, 18), seed=0, spp=2, max_bounces=8, device="cpu")
    assert torch.equal(img, want)
    # the PNG holds the half-resolution preview, and nothing else was written
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame.png"]
    words = pack_rgba8888(want.numpy()[::2, ::2])
    rgba = read_png(out)
    assert rgba.shape == (9, 16, 4)
    np.testing.assert_array_equal(rgba[..., 0], (words >> 24) & 0xFF)
    np.testing.assert_array_equal(rgba[..., 2], (words >> 8) & 0xFF)
    assert (docs.stat().st_mtime_ns if docs.exists() else None) == docs_before
    assert (os.stat(default).st_mtime_ns if os.path.exists(default) else None) == default_before


def test_big_scene_training_loss_falls(capsys):
    got = big_scene_training.main(["--spheres", "24", "--size", "32x24", "--steps", "3",
                                   "--device", "cpu"])
    losses = got["losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    e0, e1 = got["mae"]
    assert e1 < e0
    assert "held-out image MAE" in capsys.readouterr().out


def test_inverse_rendering_loss_falls(tmp_path):
    got = inverse_rendering.main(["--steps", "3", "--device", "cpu", "--out", str(tmp_path)])
    losses = got["losses"]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["after.png", "before.png",
                                                          "target.png"]
    assert read_png(tmp_path / "after.png").shape == (64, 96, 4)


def test_examples_take_device_not_cpu():
    for mod in (big_scene_training, inverse_rendering):
        with pytest.raises(SystemExit):
            mod.main(["--cpu"])
