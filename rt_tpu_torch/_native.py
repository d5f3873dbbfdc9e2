"""The native C++ runtime: the multithreaded CPU baseline tracer, the
RGBA8888 packer and the PNG writer (port of ``rt_tpu._native``).

The library is ``native/rt_native.cpp`` at the repository root, a plain C
ABI loaded with :mod:`ctypes`.  It is the measured CPU baseline behind a
headline's ``vs_baseline``, so it is compiled with the ``CXXFLAGS`` and
``LDFLAGS`` that ``native/Makefile`` sets (``-O3 -march=native
-ffast-math``), read from the Makefile at each build: other flags would
measure another baseline.

Loading follows the JAX package's order: ``native/librt_native.so`` (what
``make -C native`` builds) first, then this package's own build,
``rt_tpu_torch/_build/librt_native-<hash>.so``, keyed on a hash of the
source, the flags and the host's CPU model (``-march=native`` builds for
the CPU it runs on).  :func:`available` only loads, as the JAX version
does; :func:`render_cpu` builds the library at its first use when none
loads, and raises where no C++ compiler exists: a baseline is measured or
it is an error, never 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "build", "make_flags", "write_png", "render_mg_cpu", "render_cpu",
           "pack_rgba8888"]

_PACKAGE = Path(__file__).resolve().parent
SOURCE = _PACKAGE.parent / "native" / "rt_native.cpp"
MAKE_LIBRARY = _PACKAGE.parent / "native" / "librt_native.so"
MAKEFILE = _PACKAGE.parent / "native" / "Makefile"
BUILD_DIR = _PACKAGE / "_build"

_LIB = None
_TRIED = False


def make_flags() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """``(CXXFLAGS, LDFLAGS)`` as ``native/Makefile`` sets them (the file is
    read, never run)."""
    text = MAKEFILE.read_text() if MAKEFILE.exists() else ""
    flags = dict(re.findall(r"^(CXXFLAGS|LDFLAGS)\s*\??=(.*)$", text, re.M))
    if sorted(flags) != ["CXXFLAGS", "LDFLAGS"]:
        raise RuntimeError(f"{MAKEFILE} does not set CXXFLAGS and LDFLAGS: cannot build the "
                           "native CPU baseline with its flags")
    return tuple(flags["CXXFLAGS"].split()), tuple(flags["LDFLAGS"].split())


def _cpu_model() -> str:
    """The host CPU's model name (what ``-march=native`` compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _built_path() -> Path:
    try:
        cxxflags, ldflags = make_flags()
    except RuntimeError:  # build() raises; the path only has to name no library
        cxxflags, ldflags = (), ()
    h = hashlib.sha256(" ".join(cxxflags + ldflags + (_cpu_model(),)).encode())
    h.update(SOURCE.read_bytes() if SOURCE.exists() else b"")
    return BUILD_DIR / f"librt_native-{h.hexdigest()[:16]}.so"


def _open(path) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rtn_write_png.restype = ctypes.c_int
    lib.rtn_write_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                  ctypes.c_int]
    lib.rtn_pack_rgba8888.restype = None
    lib.rtn_pack_rgba8888.argtypes = [f32p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong]
    lib.rtn_render.restype = ctypes.c_double
    lib.rtn_render.argtypes = [
        f32p, f32p, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64,
        f32p, f32p, i32p, ctypes.c_int,
        f32p, f32p, i32p, ctypes.c_int,
        i32p, f32p, f32p, f32p,
        ctypes.c_int,
        f32p,
    ]
    return lib


def _load():
    """The loaded library, or None; tried once per process (clear
    ``_TRIED`` to try again)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for cand in (MAKE_LIBRARY, _built_path()):
        if cand.exists():
            try:
                _LIB = _open(cand)
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    """Whether a built library loads (never builds)."""
    return _load() is not None


def build() -> Path:
    """Compile ``native/rt_native.cpp`` with ``native/Makefile``'s flags into
    this package's build directory (once per source, flags and CPU model)
    and return the library's path.  Raises ``RuntimeError`` without a C++
    compiler (``$CXX``, default g++), without the Makefile's flags, or
    when the compile fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"native source {SOURCE} not found: cannot build the CPU baseline")
    cxxflags, ldflags = make_flags()
    out = _built_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"no C++ compiler ({cxx!r} not found): cannot build the native "
                           "CPU baseline")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *cxxflags, str(SOURCE), "-o", str(tmp), *ldflags],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    """The library for the tracer: a loadable one, else this package's
    build (compiled now if needed)."""
    global _LIB, _TRIED
    lib = _load()
    if lib is None:
        _LIB, _TRIED = _open(build()), True
        lib = _LIB
    return lib


def write_png(path: str, rgba: np.ndarray, w: int, h: int) -> None:
    """Write (h, w, 4) uint8 RGBA as a PNG of stored deflate blocks."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    if rgba.size != w * h * 4:
        raise ValueError(f"write_png: {rgba.size} bytes for a {w}x{h} RGBA image")
    rc = lib.rtn_write_png(str(path).encode(),
                           rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h)
    if rc != 0:
        raise IOError(f"rtn_write_png failed with code {rc}")


def render_mg_cpu(scene, size, *, spp: int, max_bounces: int, seed: int = 0):
    """Render with the native CPU baseline tracer, mg personality."""
    return render_cpu(scene, size, spp=spp, max_bounces=max_bounces, seed=seed,
                      personality="mg")


def _host(a, dtype) -> np.ndarray:
    """A table (torch tensor on any device, or array) as contiguous host
    numpy of ``dtype``."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype)


def render_cpu(scene, size, *, spp: int, max_bounces: int, seed: int = 0,
               personality: str = "mg"):
    """Render a :class:`rt_tpu_torch.scene.Scene` with the native
    multithreaded CPU baseline tracer.  ``personality``: "mg"
    (metal+lambert, mg_ray_tracer.cpp:142-152) or "sm" (adds the dielectric
    family, sm_ray_tracer.cpp:221-236).  The scene's tables may lie on any
    device; the first ``count`` rows of the padded sphere and plane tables
    are passed, the material tables whole, no boxes (as in JAX).  Returns
    ((H, W, 3) float32 numpy image after gamma, seconds the tracer took).
    Builds the library at first use; raises ``RuntimeError`` if it cannot."""
    c = ctypes
    if personality not in ("mg", "sm"):
        raise ValueError(f"unknown personality {personality!r}")
    lib = _library()
    w, h = size
    f32, i32 = np.float32, np.int32
    cam_pos = _host(scene.camera.position, f32)
    cam_rot = _host(scene.camera.rotation, f32)  # (3, 3) row-major (rt_native.cpp:309)
    sc, pc = scene.spheres.count, scene.planes.count
    sph_c = _host(scene.spheres.center[:sc], f32)
    sph_r = _host(scene.spheres.radius[:sc], f32)
    sph_m = _host(scene.spheres.material[:sc], i32)
    pl_n = _host(scene.planes.normal[:pc], f32)
    pl_d = _host(scene.planes.d[:pc], f32)
    pl_m = _host(scene.planes.material[:pc], i32)
    mt = _host(scene.materials.type, i32)
    ma = _host(scene.materials.albedo, f32)
    mr = _host(scene.materials.roughness, f32)
    mf = _host(scene.materials.reflectivity, f32)
    out = np.empty((h, w, 3), f32)

    def p(a, t):
        return a.ctypes.data_as(c.POINTER(t))

    secs = lib.rtn_render(
        p(cam_pos, c.c_float), p(cam_rot, c.c_float),
        c.c_float(scene.camera.vfov), c.c_float(scene.camera.near),
        w, h, spp, max_bounces, seed,
        p(sph_c, c.c_float), p(sph_r, c.c_float), p(sph_m, c.c_int32), sc,
        p(pl_n, c.c_float), p(pl_d, c.c_float), p(pl_m, c.c_int32), pc,
        p(mt, c.c_int32), p(ma, c.c_float), p(mr, c.c_float), p(mf, c.c_float),
        {"mg": 0, "sm": 1}[personality],
        p(out, c.c_float),
    )
    return out, float(secs)


def pack_rgba8888(rgb: np.ndarray) -> np.ndarray:
    """Float32 (..., 4) RGBA → uint32 words via the native packer."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not available")
    rgba = np.ascontiguousarray(rgb, dtype=np.float32)
    if rgba.shape[-1] != 4:
        raise ValueError(f"pack_rgba8888: last axis {rgba.shape[-1]}, expected 4")
    out = np.empty(rgba.shape[:-1], dtype=np.uint32)
    lib.rtn_pack_rgba8888(rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), rgba.size // 4)
    return out
