"""rt_tpu_torch's host modules against rt_tpu's: scene loading (tables bit
for bit), camera, colour, materials, image writers, log, the renderer
registry and the CLI.  None of these runs a JAX render."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import camera as jcam
from rt_tpu import colour as jcol
from rt_tpu_torch import camera as tcam
from rt_tpu_torch import colour as tcol
from rt_tpu_torch import renderer as treg
from rt_tpu_torch.cli import main
from rt_tpu.viewer import ansi_preview as j_ansi_preview
from test_torch_common import BOX_TOML, SCENES, read_png
from test_torch_ops import jax_scene

REPO = SCENES.parent


def _leaves(scene):
    """(name, array) for every table of a scene of either package."""
    out = []
    for table in ("camera", "materials", "spheres", "planes", "boxes"):
        t = getattr(scene, table)
        for name in ("position", "rotation", "type", "albedo", "roughness", "reflectivity",
                     "center", "radius", "material", "normal", "d", "extents"):
            if hasattr(t, name):
                v = getattr(t, name)
                out.append((f"{table}.{name}", v.numpy() if isinstance(v, torch.Tensor)
                            else np.asarray(v)))
    return out


def _static(scene):
    return (scene.samples_per_pixel, scene.max_bounces, scene.camera.vfov, scene.camera.near,
            scene.camera.far, scene.materials.count, scene.materials.names,
            scene.spheres.count, scene.planes.count, scene.boxes.count)


def assert_scenes_equal(ts, js):
    assert _static(ts) == _static(js)
    for (name, got), (_, want) in zip(_leaves(ts), _leaves(js), strict=True):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", ["basic.toml", "dielectric.toml", "cornell_spheres.toml"])
def test_loader_tables_equal(name):
    path = str(SCENES / name)
    ts = rt_tpu_torch.load(path)
    assert ts.path == path
    assert_scenes_equal(ts, rt_tpu.load(path))
    assert_scenes_equal(rt_tpu_torch.from_jax_scene(rt_tpu.load(path)), rt_tpu.load(path))


def test_loads_edge_cases_equal():
    for text in ["", "camera = { position = 'one', direction = [1, -1, -2] }\n",
                 (SCENES / "basic.toml").read_text() + "\nsamples_per_pixel = 5000\n",
                 "planes = [ { normal = [1, 1, 0] } ]\n",
                 "materials = [ { albedo = [0.2, 3, 0] } ]\nboxes = [ { extents = 2 } ]\n"]:
        assert_scenes_equal(rt_tpu_torch.loads(text), rt_tpu.loads(text))
        assert_scenes_equal(rt_tpu_torch.loads(text, compat_colours=False),
                            rt_tpu.loads(text, compat_colours=False))


def test_loader_errors_match():
    for text in ["materials = [ { type = 'plasma' } ]",
                 "spheres = [ { material = 3 } ]",
                 "max_bounces = -1"]:
        with pytest.raises(ValueError) as want:
            rt_tpu.loads(text)
        with pytest.raises(ValueError) as got:
            rt_tpu_torch.loads(text)
        assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError, match="did not exist"):
        rt_tpu_torch.load("no/such/scene.toml")


def test_load_first_available(monkeypatch):
    monkeypatch.chdir(REPO)
    assert_scenes_equal(rt_tpu_torch.load_first_available(), rt_tpu.load_first_available())


@pytest.mark.parametrize("n", [1, 64, 500])
def test_procedural_scene_equal(n):
    assert_scenes_equal(rt_tpu_torch.scene.make_procedural_scene(n),
                        rt_tpu.scene.make_procedural_scene(n))


def test_scene_to_device_keeps_tables():
    s = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    moved = s.to("cpu")
    assert moved.spheres.count == 3 and moved.path == s.path
    assert_scenes_equal(moved, rt_tpu.load(str(SCENES / "basic.toml")))
    meta = s.to("meta")
    assert meta.spheres.center.device.type == "meta"
    assert meta.camera.rotation.device.type == "meta"


def test_look_rotation_bit_exact():
    rng = np.random.default_rng(0)
    dirs = np.concatenate([np.asarray([[0, 0, -1], [0, -0.05, -1], [0, -0.1, -1], [0, 1, 0],
                                       [0, -1, 0], [1, 0, 0]], np.float32),
                           rng.normal(size=(200, 3)).astype(np.float32)])
    for d in dirs:
        want = np.asarray(jcam.look_rotation(jnp.asarray(d)))
        np.testing.assert_array_equal(tcam.look_rotation(torch.from_numpy(d)).numpy(), want,
                                      err_msg=str(d))


def test_rotations_and_rays_close():
    js = jax_scene("cornell_spheres.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    rot = ts.camera.rotation
    for angle in (0.3, -1.2):
        np.testing.assert_allclose(tcam.rotate_yaw(rot, angle).numpy(),
                                   np.asarray(jcam.rotate_yaw(js.camera.rotation, angle)),
                                   atol=1e-6)
        np.testing.assert_allclose(tcam.rotate_pitch(rot, angle).numpy(),
                                   np.asarray(jcam.rotate_pitch(js.camera.rotation, angle)),
                                   atol=1e-6)
    pix = np.random.default_rng(1).uniform(0, 32, size=(50, 2)).astype(np.float32)
    o, d = tcam.generate_rays(ts.camera, (32, 24), torch.from_numpy(pix))
    jo, jd = jcam.generate_rays(js.camera, (32, 24), jnp.asarray(pix))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


def test_viewport_projections_close():
    """view_projection, world_to_screen and screen_to_world against the
    JAX package's (the rasterizer bounds its hits with screen_to_world)."""
    js = jax_scene("cornell_spheres.toml")
    ts = rt_tpu_torch.from_jax_scene(js)
    size = (32, 24)
    np.testing.assert_allclose(tcam.view_projection(ts.camera, size).numpy(),
                               np.asarray(jcam.view_projection(js.camera, size)), rtol=1e-6,
                               atol=1e-6)
    rng = np.random.default_rng(4)
    pix = rng.uniform(0, 24, size=(64, 2)).astype(np.float32)
    for depth in (0.0, 0.5, 1.0):
        got = tcam.screen_to_world(ts.camera, size, torch.from_numpy(pix), depth).numpy()
        want = np.asarray(jcam.screen_to_world(js.camera, size, jnp.asarray(pix), depth))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pts = (np.asarray(js.camera.position) + rng.normal(size=(64, 3)) - [0, 0, 4]).astype(np.float32)
    got_px, got_z = tcam.world_to_screen(ts.camera, size, torch.from_numpy(pts))
    want_px, want_z = jcam.world_to_screen(js.camera, size, jnp.asarray(pts))
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=1e-5, atol=1e-6)
    # a pixel un-projected at a depth projects back onto itself
    back, z = tcam.world_to_screen(ts.camera, size,
                                   tcam.screen_to_world(ts.camera, size, torch.from_numpy(pix),
                                                        0.5))
    np.testing.assert_allclose(back.numpy(), pix, atol=1e-3)
    np.testing.assert_allclose(z.numpy(), 0.5, atol=1e-4)


def test_colour_and_classes_equal():
    for name in sorted(jcol.NAMED_COLOURS):
        for compat in (True, False):
            assert tcol.resolve_colour(name, compat=compat) == jcol.resolve_colour(name, compat=compat)
    rgb = np.random.default_rng(2).uniform(-0.2, 1.3, size=(7, 5, 3)).astype(np.float32)
    words = tcol.pack_rgba8888(torch.from_numpy(rgb))
    np.testing.assert_array_equal(words, jcol.pack_rgba8888(rgb))
    np.testing.assert_array_equal(tcol.unpack_rgba8888(words), jcol.unpack_rgba8888(words))
    for p in ("mg", "sm"):
        np.testing.assert_array_equal(rt_tpu_torch.materials.personality_classes(p).numpy(),
                                      np.asarray(rt_tpu.materials.personality_classes(p)))


def test_image_writers(tmp_path):
    img = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, size=(6, 9, 3)).astype(np.float32))
    words = rt_tpu.image.to_rgba8888(img.numpy())
    np.testing.assert_array_equal(rt_tpu_torch.image.to_rgba8888(img), words)
    rt_tpu_torch.image.write_png(str(tmp_path / "a.png"), img)
    rgba = read_png(tmp_path / "a.png")
    np.testing.assert_array_equal(rgba[..., 0], (words >> 24) & 0xFF)
    np.testing.assert_array_equal(rgba[..., 3], 255)
    rt_tpu_torch.image.write_image(str(tmp_path / "a.ppm"), img)
    assert open(tmp_path / "a.ppm", "rb").read().startswith(b"P6\n9 6\n255\n")
    rt_tpu_torch.image.write_image(str(tmp_path / "a.npy"), img)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), img.numpy())
    with pytest.raises(ValueError, match="unsupported image extension"):
        rt_tpu_torch.image.write_image(str(tmp_path / "a.jpg"), img)
    fb = rt_tpu_torch.image.Framebuffer(9, 6)
    assert fb.pixels.ctypes.data % 64 == 0 and fb.position_of(10) == (1, 1)
    fb.blit(img)
    np.testing.assert_array_equal(fb.pixels, words)


def test_warn_once(capsys):
    from rt_tpu_torch import log

    log.reset_warnings()
    assert log.warn_once("k", "first") and not log.warn_once("k", "again")
    assert capsys.readouterr().err == "warning: first\n"


def test_import_needs_no_jax():
    code = ("import sys, rt_tpu_torch, rt_tpu_torch.cli, rt_tpu_torch.ops.render, "
            "rt_tpu_torch.ops.blockwise_grad, rt_tpu_torch.ops.wavefront_grad, "
            "rt_tpu_torch.train, rt_tpu_torch.rng, rt_tpu_torch.integrator, "
            "rt_tpu_torch.replay, rt_tpu_torch.diff, rt_tpu_torch.ops.intersect, "
            "rt_tpu_torch.renderer, rt_tpu_torch.camera, rt_tpu_torch._native, "
            "rt_tpu_torch.viewer, rt_tpu_torch.render_4k, rt_tpu_torch.profiling, "
            "rt_tpu_torch.examples.inverse_rendering, "
            "rt_tpu_torch.examples.big_scene_training, rt_tpu_torch.dist, "
            "rt_tpu_torch.mp_check, rt_tpu_torch.examples.sharded_render, "
            "rt_tpu_torch.bench_table, rt_tpu_torch.bench; "
            "assert 'jax' not in sys.modules and 'rt_tpu' not in sys.modules; "
            "assert 'triton' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(REPO)})


def test_registry_and_auto_route():
    assert [d.name for d in treg.all_renderers()] == [d.name for d in
                                                      rt_tpu.renderer.all_renderers()]
    assert treg.find_by_name_fuzzy("mg_a").name == "mg_auto"
    assert treg.find_by_name_fuzzy("sm").name == "sm_ray_tracer"
    assert treg.find_by_name_fuzzy("mg").name == "mg_ray_tracer"
    with pytest.raises(KeyError):
        treg.create("zz_tracer")
    basic = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    assert treg.auto_route(basic, "cuda") == "pallas"
    assert treg.auto_route(basic, "cpu") == "pallas"
    big = rt_tpu_torch.scene.make_procedural_scene(700)
    assert treg.auto_route(big, "cuda") == "blockwise"
    img = treg.create("mg_auto")(big, (8, 8), seed=1, spp=1, max_bounces=1, device="cpu")
    assert torch.equal(img, treg.create("mg_blockwise")(big, (8, 8), seed=1, spp=1,
                                                        max_bounces=1, device="cpu"))
    # past JAX's wavefront crossover the port stays on blockwise; the
    # wavefront renders the same frame by name
    huge = rt_tpu_torch.scene.make_procedural_scene(5000)
    assert treg.auto_route(huge, "cuda") == "blockwise"
    img = treg.create("mg_auto")(huge, (8, 8), spp=1, max_bounces=1, device="cpu")
    assert torch.equal(img, treg.create("mg_wavefront")(huge, (8, 8), spp=1, max_bounces=1,
                                                        device="cpu"))
    # past the kernels' 16384 primitives: the jnp-style integrator, with a warning
    past = rt_tpu_torch.scene.make_procedural_scene(17000)
    assert treg.auto_route(past, "cuda") == treg.auto_route(past, "cpu") == "jnp"
    img = treg.create("mg_auto")(past, (8, 8), seed=3, spp=1, max_bounces=1, device="cpu")
    assert torch.equal(img, rt_tpu_torch.integrator.render_image(
        past, (8, 8), rt_tpu_torch.rng.make_key(3), spp=1, max_bounces=1, device="cpu"))
    img = treg.create("sm_pallas")(basic, (8, 6), seed=2, spp=1, max_bounces=2, device="cpu")
    assert img.shape == (6, 8, 3)
    img = treg.create("mg_ray_tracer")(basic, (8, 6), seed=2, spp=1, max_bounces=2, device="cpu")
    assert torch.equal(img, treg.create("mg_ray_tracer")(
        basic, (8, 6), rt_tpu_torch.rng.make_key(2), spp=1, max_bounces=2, device="cpu"))
    assert treg.create("null")(basic, (8, 6), device="cpu").abs().max() == 0


def test_auto_route_warns_past_the_kernels(capsys):
    from rt_tpu_torch import log

    log.reset_warnings()
    past = rt_tpu_torch.scene.make_procedural_scene(17000)
    for _ in range(2):
        treg.create("sm_auto")(past, (4, 2), spp=1, max_bounces=1, device="cpu")
    err = capsys.readouterr().err
    assert err.count("warning: auto renderer") == 1 and "17000 primitives > 16384" in err


def test_cli(tmp_path, capsys):
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == [d.name for d in rt_tpu.renderer.all_renderers()]
    out = tmp_path / "img.png"
    rc = main(["--scene", str(SCENES / "dielectric.toml"), "--renderer", "sm", "--size", "12x8",
               "--spp", "1", "--bounces", "2", "--device", "cpu", "--out", str(out)])
    assert rc == 0 and read_png(out).shape == (8, 12, 4)
    assert "created renderer: sm_ray_tracer" in capsys.readouterr().out
    # the default renderer is mg_ray_tracer, keyed by --seed
    rc = main(["--scene", str(SCENES / "basic.toml"), "--size", "8x6", "--spp", "1",
               "--bounces", "2", "--seed", "4", "--device", "cpu", "--out", str(tmp_path / "d.npy")])
    assert rc == 0 and "created renderer: mg_ray_tracer" in capsys.readouterr().out
    want = rt_tpu_torch.integrator.render_image(rt_tpu_torch.load(str(SCENES / "basic.toml")),
                                                (8, 6), rt_tpu_torch.rng.make_key(4), spp=1,
                                                max_bounces=2, device="cpu")
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), want.numpy())
    assert main(["--procedural", "10", "--size", "8x6", "--spp", "1", "--device", "cpu",
                 "--out", str(tmp_path / "p.npy")]) == 0
    assert np.load(tmp_path / "p.npy").shape == (6, 8, 3)
    assert main(["--renderer", "zzz"]) == 2
    assert main(["--size", "big"]) == 2
    assert main(["--scene", "missing.toml", "--device", "cpu"]) == 1
    # --mesh takes the path tracers only (the sharded render: test_torch_dist.py)
    assert main(["--mesh", "8", "--renderer", "rasterizer", "--device", "cpu"]) == 2
    # --preview prints the frame's half-blocks after writing it
    rc = main(["--scene", str(SCENES / "basic.toml"), "-r", "mg_auto", "--size", "16x8", "--spp",
               "1", "--bounces", "2", "--preview", "--device", "cpu", "--out",
               str(tmp_path / "v.npy")])
    text = capsys.readouterr().out
    assert rc == 0 and text.count("▀") == 16 * 4
    assert text.endswith(j_ansi_preview(np.load(tmp_path / "v.npy")) + "\n")
    # --interactive runs the viewer before the renderer is resolved; without
    # a terminal it draws its first frame and waits for keys, so it is
    # driven through a pty in tests/test_torch_viewer.py
    # as JAX's CLI: the kernel renderers draw with seed 0 whatever --seed says
    rc = main(["--scene", str(SCENES / "basic.toml"), "-r", "mg_pallas", "--size", "8x6",
               "--spp", "1", "--bounces", "2", "--seed", "3", "--device", "cpu", "--out",
               str(tmp_path / "s.npy")])
    want = rt_tpu_torch.ops.render.render_forward(rt_tpu_torch.load(str(SCENES / "basic.toml")),
                                                  (8, 6), seed=0, spp=1, max_bounces=2,
                                                  device="cpu")
    assert rc == 0
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), want.numpy())
    # --boxes reaches only the ray tracers: mg_auto renders the box scene
    # without its box, mg_ray_tracer traces it
    box_scene = tmp_path / "box.toml"
    box_scene.write_text((SCENES / "basic.toml").read_text() + BOX_TOML)
    scene = rt_tpu_torch.load(str(box_scene))
    for renderer, boxes in (("mg_auto", False), ("mg_ray_tracer", True)):
        out_b = tmp_path / f"{renderer}.npy"
        assert main(["--scene", str(box_scene), "-r", renderer, "--size", "12x8", "--spp", "1",
                     "--bounces", "2", "--boxes", "--device", "cpu", "--out", str(out_b)]) == 0
        kw = dict(spp=1, max_bounces=2, device="cpu")
        if renderer == "mg_auto":
            with_boxes = treg.create(renderer)(scene, (12, 8), include_boxes=True, **kw)
            without = treg.create(renderer)(scene, (12, 8), **kw)
        else:
            key = rt_tpu_torch.rng.make_key(0)
            with_boxes = treg.create(renderer)(scene, (12, 8), key, include_boxes=True, **kw)
            without = treg.create(renderer)(scene, (12, 8), key, **kw)
        assert not torch.equal(with_boxes, without)
        np.testing.assert_array_equal(np.load(out_b), (with_boxes if boxes else without).numpy())
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--scene", str(SCENES / "basic.toml"), "--size", "8x6",
                  "--out", str(tmp_path / "c.png")])


def test_profiling_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the test checks a CUDA-less host")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt_tpu_torch.profiling.sustained(lambda i: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt_tpu_torch.profiling.device_times(lambda i: None)
    assert rt_tpu_torch.profiling.mrays_per_sec((800, 600), 4, 0.001) == pytest.approx(1920.0)


def test_package_data_covers_kernel_includes():
    """Every ``#include "..."`` of a kernel source matches a pattern of
    pyproject.toml's package data, so an installed package can build its
    kernels."""
    import fnmatch
    import re
    import tomllib

    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = data["tool"]["setuptools"]["package-data"]["rt_tpu_torch"]
    csrc = REPO / "rt_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    assert sources
    for src in sources + sorted(csrc.glob("*.cuh")):
        assert any(fnmatch.fnmatch(f"csrc/{src.name}", p) for p in patterns), src.name
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (csrc / inc).is_file(), (src.name, inc)
            assert any(fnmatch.fnmatch(f"csrc/{inc}", p) for p in patterns), (src.name, inc)


def test_fma_peak_plain_on_the_cpu():
    """The FMA probe's wrapper runs its plain version on a CPU tensor (no
    launch), which is the float64 reference of the two chains rounded to
    float32 at every step; measuring needs the card."""
    from rt_tpu_torch import roofline

    x = torch.full((256, 128), 1.0 + 3e-6)
    x[5, 7] = 0.75
    before = roofline.fma_peak.launches
    out = roofline.fma_peak(x, 8, tiles=2)
    assert roofline.fma_peak.launches == before and out.shape == (512, 128)
    a = np.float32(0.75) * np.float32(1.0 + np.float32(1e-9))  # tile 1
    m1 = np.float32(np.float32(a * np.float32(0.4999999)) + np.float32(0.5))
    m2 = np.float32(np.float32(a * np.float32(0.5000001)) + np.float32(0.5))
    d = np.float32(a * np.float32(1e-7))
    b, c = np.float32(a), np.float32(np.float32(a) + d)
    for _ in range(4):
        b = np.float32(np.float64(b) * np.float64(m1) + np.float64(d))
        c = np.float32(np.float64(c) * np.float64(m2) - np.float64(d))
    assert out[256 + 5, 7].item() == pytest.approx(float(b + c), rel=1e-6)
    with pytest.raises(ValueError, match="k_fma"):
        roofline.fma_peak(x, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            roofline.measure_fma_peak(64)
