"""rt_tpu_torch._native against rt_tpu._native: what each package's
``render_cpu`` hands the native tracer (captured by a stand-in library),
the packed words, the PNG bytes in both library states, and the tracer's
estimator against the port's renderers.

The native tracer cannot be compared frame for frame: an atomic row
counter hands rows to threads and each thread seeds its RNG by its index
(native/rt_native.cpp:326-335), so two calls at one seed can differ.  Its
marshalling is held exactly and its estimator statistically."""

import ctypes

import numpy as np
import pytest
import torch

import rt_tpu
import rt_tpu_torch
from rt_tpu import _native as jnative
from rt_tpu_torch import _native as tnative
from rt_tpu_torch import renderer as treg
from test_torch_common import SCENES, read_png

PLANE_BOX_TOML = """
materials = [ { type = 'lambert', albedo = 'red' },
              { type = 'metal',   albedo = 'white', roughness = 0.1 },
              { type = 'lambert', albedo = [0.2, 0.5, 0.8] } ]
planes  = [ { material = 0 }, { material = 1, position = [0, 0, -6], normal = [0, 0, 1] } ]
spheres = [ { material = 1, position = [0.0, 1.0, -3.0], radius = 0.5 } ]
boxes = [ { material = 2, position = [-1, 0.5, -2.5], extents = [0.3, 0.5, 0.3] } ]
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests run many small eager ops, which gain nothing from
    intra-op threads; one thread keeps them from oversubscribing the cores
    that parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built_lib():
    """The library as the port builds it (native/Makefile's flags)."""
    try:
        path = tnative.build()
    except RuntimeError as ex:
        pytest.skip(f"the native library cannot be built here: {ex}")
    return tnative._open(path)


def _use(monkeypatch, lib):
    """Both packages see ``lib`` (None: no library) as their loaded library."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_LIB", lib)
        monkeypatch.setattr(mod, "_TRIED", True)


class _Recorder:
    """A stand-in library: ``rtn_render`` copies every array it is handed
    (lengths from the counts it is given) and fills the frame with 0.25."""

    def __init__(self, n_materials):
        self.n_mat = n_materials
        self.calls = []

    def rtn_render(self, cam_pos, cam_rot, vfov, near, w, h, spp, max_bounces, seed,
                   sph_c, sph_r, sph_m, sc, pl_n, pl_d, pl_m, pc, mt, ma, mr, mf, pers, out):
        def arr(p, n):
            return np.ctypeslib.as_array(p, shape=(n,)).copy() if n else np.zeros(0)

        m = self.n_mat
        self.calls.append({
            "cam_pos": arr(cam_pos, 3), "cam_rot": arr(cam_rot, 9), "vfov": vfov.value,
            "near": near.value, "ints": (w, h, spp, max_bounces, seed, sc, pc, pers),
            "sph_c": arr(sph_c, 3 * sc), "sph_r": arr(sph_r, sc), "sph_m": arr(sph_m, sc),
            "pl_n": arr(pl_n, 3 * pc), "pl_d": arr(pl_d, pc), "pl_m": arr(pl_m, pc),
            "mt": arr(mt, m), "ma": arr(ma, 4 * m), "mr": arr(mr, m), "mf": arr(mf, m),
        })
        np.ctypeslib.as_array(out, shape=(h * w * 3,))[:] = 0.25
        return 1.5


@pytest.mark.parametrize("name,personality", [("basic.toml", "mg"), ("dielectric.toml", "sm"),
                                              ("plane+box", "mg")])
def test_render_cpu_marshalling_equal(monkeypatch, name, personality):
    if name == "plane+box":
        js, ts = rt_tpu.loads(PLANE_BOX_TOML), rt_tpu_torch.loads(PLANE_BOX_TOML)
        assert ts.planes.count == 2 and ts.boxes.count == 1
    else:
        js, ts = rt_tpu.load(str(SCENES / name)), rt_tpu_torch.load(str(SCENES / name))
    rec = _Recorder(int(ts.materials.type.shape[0]))
    _use(monkeypatch, rec)
    kw = dict(spp=3, max_bounces=5, seed=11, personality=personality)
    j_img, j_s = jnative.render_cpu(js, (10, 6), **kw)
    t_img, t_s = tnative.render_cpu(ts, (10, 6), **kw)
    assert (j_s, t_s) == (1.5, 1.5)
    np.testing.assert_array_equal(t_img, j_img)
    assert t_img.shape == (6, 10, 3) and t_img.dtype == np.float32
    want, got = rec.calls
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    # the padded tables are cut to their counts; the rotation goes row-major
    assert want["ints"][5:7] == (ts.spheres.count, ts.planes.count)
    np.testing.assert_array_equal(got["cam_rot"], ts.camera.rotation.numpy().ravel())


def test_render_cpu_makes_host_contiguous_tables(monkeypatch):
    """A scene whose tables are float64 or strided goes over as
    contiguous float32/int32 host arrays."""
    ts = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    rec = _Recorder(int(ts.materials.type.shape[0]))
    _use(monkeypatch, rec)
    tnative.render_cpu(ts, (4, 2), spp=1, max_bounces=1)
    odd = ts.to("cpu")
    odd = rt_tpu_torch.diff.apply_params(odd, {
        "camera.rotation": ts.camera.rotation.T.contiguous().T,  # a transposed view's layout
        "materials.albedo": ts.materials.albedo.double()})
    tnative.render_cpu(odd, (4, 2), spp=1, max_bounces=1)
    a, b = rec.calls
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pack_rgba8888_words_equal(monkeypatch, built_lib):
    _use(monkeypatch, built_lib)
    rgba = np.random.default_rng(3).uniform(-0.5, 1.5, (37, 23, 4)).astype(np.float32)
    rgba[0, :4] = [[0.0, 1.0, 0.5, 2.0], [-1.0, 0.25, 0.999, 1.0], [1 / 255, 254.5 / 255, 0, 1],
                   [np.nextafter(np.float32(1), np.float32(0)), 0, 0, 0]]
    got = tnative.pack_rgba8888(rgba)
    assert got.dtype == np.uint32 and got.shape == (37, 23)
    np.testing.assert_array_equal(got, jnative.pack_rgba8888(rgba))


def test_write_png_bytes_equal_in_both_library_states(monkeypatch, tmp_path, built_lib):
    rng = np.random.default_rng(5)
    img = rng.uniform(-0.1, 1.1, (19, 27, 3)).astype(np.float32)
    words = rng.integers(0, 2**32, (9, 14), dtype=np.uint32)
    decoded = {}
    for state, lib in (("library", built_lib), ("zlib", None)):
        _use(monkeypatch, lib)
        assert tnative.available() == (lib is not None)
        for label, arr, tarr in (("float", img, torch.from_numpy(img)), ("words", words, words)):
            jp, tp = tmp_path / f"j_{state}_{label}.png", tmp_path / f"t_{state}_{label}.png"
            rt_tpu.image.write_png(str(jp), arr)
            rt_tpu_torch.image.write_png(str(tp), tarr)
            assert tp.read_bytes() == jp.read_bytes(), (state, label)
            decoded[state, label] = read_png(tp)
    for label in ("float", "words"):
        np.testing.assert_array_equal(decoded["library", label], decoded["zlib", label])
    # the two states differ in their bytes: stored blocks against zlib level 6
    assert ((tmp_path / "t_library_float.png").read_bytes()
            != (tmp_path / "t_zlib_float.png").read_bytes())


@pytest.mark.parametrize("personality,scene", [("mg", "basic.toml"), ("sm", "dielectric.toml")])
def test_native_tracer_statistical_parity(monkeypatch, built_lib, personality, scene):
    """The native estimator against the port's ``mg``/``sm`` renderer (the
    jnp-style integrator) at equal spp: independent draws, so the mean
    difference is held to the Monte Carlo tolerance of tests/test_native.py."""
    _use(monkeypatch, built_lib)
    s = rt_tpu_torch.load(str(SCENES / scene))
    size, spp = (100, 75), 32
    img_n, secs = tnative.render_cpu(s, size, spp=spp, max_bounces=8, personality=personality)
    assert secs > 0 and np.isfinite(img_n).all()
    img_t = treg.create(personality)(s, size, rt_tpu_torch.rng.make_key(7), spp=spp,
                                     max_bounces=8, device="cpu").numpy()
    d = np.abs(img_n - img_t).mean()
    assert d < 0.015, f"mean abs diff {d:.4f}"


def test_available_never_builds_and_render_cpu_raises(monkeypatch, tmp_path):
    """Without a loadable library ``available()`` is False and builds
    nothing; ``render_cpu`` then builds, and without a compiler it raises
    (no baseline of 0 seconds)."""
    monkeypatch.setattr(tnative, "MAKE_LIBRARY", tmp_path / "missing" / "librt_native.so")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    assert not tnative.available()
    assert not (tmp_path / "build").exists()
    monkeypatch.setenv("CXX", "no-such-compiler-rt")
    s = rt_tpu_torch.load(str(SCENES / "basic.toml"))
    with pytest.raises(RuntimeError, match="no C.. compiler"):
        tnative.render_cpu(s, (4, 3), spp=1, max_bounces=1)
    with pytest.raises(RuntimeError, match="not available"):
        tnative.pack_rgba8888(np.zeros((1, 4), np.float32))


def test_build_takes_the_makefile_flags(monkeypatch, tmp_path):
    """``build`` compiles with the CXXFLAGS and LDFLAGS that native/Makefile
    sets, and the cached library's name changes with those flags and with
    the host's CPU model (``-march=native``)."""
    makefile = tmp_path / "Makefile"
    makefile.write_text(tnative.MAKEFILE.read_text())
    monkeypatch.setattr(tnative, "MAKEFILE", makefile)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    argv_file = tmp_path / "argv"
    cxx = tmp_path / "fake-cxx"
    cxx.write_text('#!/bin/sh\nprintf "%s\\n" "$@" > "' + str(argv_file) + '"\n'
                   'while [ "$1" != "-o" ]; do shift; done; : > "$2"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    cxxflags, ldflags = tnative.make_flags()
    assert {"-O3", "-march=native", "-ffast-math"} <= set(cxxflags)
    assert ldflags == ("-shared", "-pthread")
    out = tnative.build()
    assert out == tnative._built_path() and out.exists()
    argv = argv_file.read_text().split()
    assert argv == [*cxxflags, str(tnative.SOURCE), "-o", argv[len(cxxflags) + 2], *ldflags]
    monkeypatch.setattr(tnative, "_cpu_model", lambda: "another CPU")
    assert tnative._built_path() != out
    monkeypatch.undo()
    monkeypatch.setattr(tnative, "MAKEFILE", makefile)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    assert tnative._built_path() == out
    makefile.write_text(makefile.read_text().replace("-O3", "-O2"))
    assert tnative.make_flags()[0][0] == "-O2" and tnative._built_path() != out
    makefile.write_text("CXX ?= g++\n")
    with pytest.raises(RuntimeError, match="does not set CXXFLAGS"):
        tnative.build()


def test_load_order_prefers_the_make_library(monkeypatch, tmp_path, built_lib):
    """``native/librt_native.so`` loads first, the port's build second."""
    import shutil

    built = tnative._built_path()
    make_lib = tmp_path / "librt_native.so"
    shutil.copy(built, make_lib)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "MAKE_LIBRARY", make_lib)
    assert tnative.available() and tnative._LIB._name == str(make_lib)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "MAKE_LIBRARY", tmp_path / "missing.so")
    assert tnative.available() and tnative._LIB._name == str(built)
    assert isinstance(tnative._LIB, ctypes.CDLL)
