"""Scene model + TOML loader (port of ``rt_tpu.scene``).

* The TOML schema, search-path resolution, defaults, clamps and aliases of
  the reference's ``scene.cpp`` (scene.cpp:483-643) are reproduced exactly,
  so reference scene files load unchanged.
* The structure-of-arrays tables of ``soa.toml`` become frozen dataclasses
  of torch tensors, padded to the same bucket sizes and fill values as the
  JAX package (so both packages hold identical tables).  Tables are built
  on the CPU; :meth:`Scene.to` moves every tensor to a device.
* :func:`from_jax_scene` carries a JAX package scene over bit for bit, so
  that the tests render both packages from identical tables.
"""

from __future__ import annotations

import dataclasses
import io
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

from .colour import resolve_colour

__all__ = [
    "MATERIAL_TYPES",
    "MATERIAL_DEFAULT_REFLECTIVITY",
    "Camera",
    "Materials",
    "Spheres",
    "Planes",
    "Boxes",
    "Scene",
    "from_jax_scene",
    "load",
    "load_first_available",
    "loads",
    "make_procedural_scene",
]

# material_type enum, common.hpp:105-115
MATERIAL_TYPES: dict[str, int] = {
    "lambert": 0,
    "metal": 1,
    "dielectric": 2,
    "air": 3,
    "vacuum": 4,
    "water": 5,
    "ice": 6,
    "diamond": 7,
}
_MATERIAL_NAMES = {v: k for k, v in MATERIAL_TYPES.items()}

# Per-type default "reflectivity" (doubling as IOR for the dielectric family),
# scene.cpp:546-556.
MATERIAL_DEFAULT_REFLECTIVITY: dict[int, float] = {
    MATERIAL_TYPES["metal"]: 0.8,
    MATERIAL_TYPES["dielectric"]: 1.52,
    MATERIAL_TYPES["air"]: 1.000293,
    MATERIAL_TYPES["vacuum"]: 1.0,
    MATERIAL_TYPES["ice"]: 1.31,
    MATERIAL_TYPES["water"]: 1.333,
}
_DEFAULT_REFLECTIVITY_OTHER = 0.5

# Vector string aliases, scene.cpp:118-144.  muu's
# conventions: y-up, right-handed, camera forward is -z (verified against the
# bundled scenes: a camera at z=+3 with direction='forward' sees spheres at
# z=0).
_VECTOR_ALIASES: dict[str, tuple[float, float, float]] = {
    "origin": (0.0, 0.0, 0.0),
    "zero": (0.0, 0.0, 0.0),
    "one": (1.0, 1.0, 1.0),
    "forward": (0.0, 0.0, -1.0),
    "back": (0.0, 0.0, 1.0),
    "backward": (0.0, 0.0, 1.0),
    "up": (0.0, 1.0, 0.0),
    "down": (0.0, -1.0, 0.0),
    "left": (-1.0, 0.0, 0.0),
    "right": (1.0, 0.0, 0.0),
    "x": (1.0, 0.0, 0.0),
    "x_axis": (1.0, 0.0, 0.0),
    "y": (0.0, 1.0, 0.0),
    "y_axis": (0.0, 1.0, 0.0),
    "z": (0.0, 0.0, 1.0),
    "z_axis": (0.0, 0.0, 1.0),
}

# Scene-file search prefixes, scene.cpp:479-480.
PATH_SEARCH_PREFIXES = ("scenes/", "../scenes/", "../../scenes/", "", "../", "../../")

_MIN_BUCKET = 8


def _t(a) -> torch.Tensor:
    """A CPU tensor holding a copy of the array ``a``."""
    return torch.from_numpy(np.array(a))


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _pad_rows(arr: np.ndarray, bucket: int, fill: float = 0.0) -> np.ndarray:
    pad = bucket - arr.shape[0]
    if pad <= 0:
        return arr
    pad_shape = (pad,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


class _Tables:
    """Mixin for the dataclasses below: ``.to(device)`` moves every tensor
    field (and every nested table) and keeps the static fields."""

    def to(self, device):
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _Tables)):
                moved[f.name] = v.to(device)
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass(frozen=True)
class Camera(_Tables):
    """Pinhole camera: pose = position + orthonormal rotation matrix.

    Mirrors ``rt::camera`` (camera.hpp:51-138): vfov = pi/4, near = 0.01,
    far = 1000.  The rotation maps camera space (x=right, y=up,
    -z=forward) to world space.
    """

    position: torch.Tensor  # (3,) f32
    rotation: torch.Tensor  # (3,3) f32, columns = (right, up, backward)
    vfov: float = float(math.pi / 4)
    near: float = 0.01
    far: float = 1000.0

    @staticmethod
    def from_pose(position, direction, *, vfov=float(math.pi / 4), near=0.01, far=1000.0) -> "Camera":
        """Build a camera looking along ``direction`` (camera.hpp:116-119)."""
        from .camera import look_rotation

        pos = torch.as_tensor(np.asarray(position, dtype=np.float32))
        rot = look_rotation(torch.as_tensor(np.asarray(direction, dtype=np.float32)))
        return Camera(position=pos, rotation=rot, vfov=vfov, near=near, far=far)


@dataclasses.dataclass(frozen=True)
class Materials(_Tables):
    """Columnar material table (soa.toml:6-16)."""

    type: torch.Tensor          # (M,) int32, material_type enum
    albedo: torch.Tensor        # (M, 4) f32 RGBA
    roughness: torch.Tensor     # (M,) f32
    reflectivity: torch.Tensor  # (M,) f32 (doubles as IOR for dielectrics)
    count: int = 0
    names: tuple = ()           # material display names


@dataclasses.dataclass(frozen=True)
class Spheres(_Tables):
    """Columnar sphere table (soa.toml:25-33)."""

    center: torch.Tensor    # (S, 3) f32
    radius: torch.Tensor    # (S,) f32
    material: torch.Tensor  # (S,) int32
    count: int = 0


@dataclasses.dataclass(frozen=True)
class Planes(_Tables):
    """Columnar plane table (soa.toml:18-24).  Plane equation: n·x + d = 0
    with d = -dot(n, position) (scene.cpp:580-583)."""

    normal: torch.Tensor    # (P, 3) f32, unit
    d: torch.Tensor         # (P,) f32
    material: torch.Tensor  # (P,) int32
    count: int = 0


@dataclasses.dataclass(frozen=True)
class Boxes(_Tables):
    """Columnar axis-aligned box table (soa.toml:35-45): centre + half-extents."""

    center: torch.Tensor    # (B, 3) f32
    extents: torch.Tensor   # (B, 3) f32 (half-extents)
    material: torch.Tensor  # (B,) int32
    count: int = 0


@dataclasses.dataclass(frozen=True)
class Scene(_Tables):
    """The full scene (scene.hpp:8-25 equivalent)."""

    camera: Camera
    materials: Materials
    spheres: Spheres
    planes: Planes
    boxes: Boxes
    samples_per_pixel: int = 30
    max_bounces: int = 10
    path: str = ""


def from_jax_scene(js) -> Scene:
    """The JAX package's ``rt_tpu.scene.Scene`` as this package's
    :class:`Scene`, bit for bit.

    ``js`` is read by attribute only: every array leaf goes through
    ``np.array`` (which a JAX array supports without this package importing
    JAX) and every static field is copied as it is."""
    cam = js.camera
    m, s, p, b = js.materials, js.spheres, js.planes, js.boxes
    return Scene(
        camera=Camera(position=_t(cam.position), rotation=_t(cam.rotation),
                      vfov=float(cam.vfov), near=float(cam.near), far=float(cam.far)),
        materials=Materials(type=_t(m.type), albedo=_t(m.albedo), roughness=_t(m.roughness),
                            reflectivity=_t(m.reflectivity), count=int(m.count),
                            names=tuple(m.names)),
        spheres=Spheres(center=_t(s.center), radius=_t(s.radius), material=_t(s.material),
                        count=int(s.count)),
        planes=Planes(normal=_t(p.normal), d=_t(p.d), material=_t(p.material), count=int(p.count)),
        boxes=Boxes(center=_t(b.center), extents=_t(b.extents), material=_t(b.material),
                    count=int(b.count)),
        samples_per_pixel=int(js.samples_per_pixel),
        max_bounces=int(js.max_bounces),
        path=str(js.path),
    )


# ---------------------------------------------------------------------------
# TOML deserialization (mirrors scene.cpp:89-481)
# ---------------------------------------------------------------------------


class _SourceMap:
    """Best-effort TOML source positions for semantic loader errors.

    The reference threads ``node.source()`` into every loader error
    (scene.cpp:58-66: toml++ keeps per-node source regions).  Python's
    tomllib discards positions, so this small scanner re-locates
    (section, index, key) in the original text: inline arrays-of-tables
    (``spheres = [ {..}, {..} ]``), ``[[section]]`` blocks, ``[section]``
    tables and top-level keys.  Strings and comments are skipped while
    brace-counting.  ``locate`` returns (line, column) 1-based, or None
    when it cannot tell (the error is then raised without a position)."""

    def __init__(self, text: str):
        self.text = text

    def _pos(self, off: int) -> tuple[int, int]:
        line = self.text.count("\n", 0, off) + 1
        col = off - self.text.rfind("\n", 0, off)
        return line, col

    def _scan_spans(self, start: int):
        """From an opening '[' at ``start``, yield (elem_start, elem_end)
        offsets of each depth-1 inline-table/array element."""
        text = self.text
        depth = 0
        i = start
        n = len(text)
        elem_start = None
        while i < n:
            c = text[i]
            if c == "#":
                i = text.find("\n", i)
                if i < 0:
                    return
                continue
            if c in "\"'":
                q = c
                i += 1
                while i < n and text[i] != q:
                    i += 2 if (q == '"' and text[i] == "\\") else 1
                i += 1
                continue
            if c in "[{":
                depth += 1
                if depth == 2 and elem_start is None:
                    elem_start = i
            elif c in "]}":
                depth -= 1
                if depth == 1 and elem_start is not None:
                    yield (elem_start, i + 1)
                    elem_start = None
                elif depth == 0:
                    return
            i += 1

    def _match_end(self, start: int) -> int:
        """Offset one past the bracket matching the one at ``start``."""
        text = self.text
        depth = 0
        i = start
        n = len(text)
        while i < n:
            c = text[i]
            if c == "#":
                nl = text.find("\n", i)
                if nl < 0:
                    return n
                i = nl
                continue
            if c in "\"'":
                q = c
                i += 1
                while i < n and text[i] != q:
                    i += 2 if (q == '"' and text[i] == "\\") else 1
                i += 1
                continue
            if c in "[{":
                depth += 1
            elif c in "]}":
                depth -= 1
                if depth == 0:
                    return i + 1
            i += 1
        return n

    def _find_key(self, key: str, lo: int, hi: int):
        import re

        m = re.search(r"(?<![\w'\"-])%s\s*=" % re.escape(key),
                      self.text[lo:hi])
        return lo + m.start() if m else None

    def locate(self, section=None, index=None, key=None):
        import re

        text = self.text
        if section is None:
            # top-level key
            m = re.search(r"(?m)^\s*%s\s*=" % re.escape(key or ""), text)
            return self._pos(m.start() + len(m.group()) - len(m.group().lstrip())) if m else None
        # section as inline array assignment
        m = re.search(r"(?m)^\s*%s\s*=\s*\[" % re.escape(section), text)
        spans = []
        if m:
            spans = list(self._scan_spans(text.find("[", m.end() - 1)))
        else:
            # [[section]] blocks / [section] table
            heads = [h.start() for h in re.finditer(
                r"(?m)^\s*\[\[%s\]\]" % re.escape(section), text)]
            if heads:
                for k, h in enumerate(heads):
                    nxt = re.compile(r"(?m)^\s*\[").search(text, text.find("\n", h) + 1)
                    spans.append((h, nxt.start() if nxt else len(text)))
            else:
                h = re.search(r"(?m)^\s*\[%s\]" % re.escape(section), text)
                if h is None:
                    # inline table: section = { ... }
                    h = re.search(r"(?m)^\s*%s\s*=\s*\{" % re.escape(section), text)
                    if h is None:
                        return None
                    open_ = text.find("{", h.end() - 1)
                    lo, hi = h.start(), self._match_end(open_)
                else:
                    nxt = re.compile(r"(?m)^\s*\[").search(text, text.find("\n", h.start()) + 1)
                    lo, hi = h.start(), (nxt.start() if nxt else len(text))
                if key:
                    off = self._find_key(key, lo, hi)
                    return self._pos(off) if off is not None else self._pos(lo)
                return self._pos(lo)
        if index is None or index >= len(spans):
            return self._pos(m.start()) if m else None
        lo, hi = spans[index]
        if key:
            off = self._find_key(key, lo, hi)
            if off is not None:
                return self._pos(off)
        return self._pos(lo)


def _deser_vec3(value, default: tuple[float, float, float]) -> np.ndarray:
    """Vector deserialization: string alias | scalar broadcast | array
    (scene.cpp:118-167).  Arrays may be shorter than 3; missing components
    keep the default? No — the reference default-initializes `val` to the
    caller's default and overwrites only provided components for matrices,
    but for vectors the caller passes the default object and components are
    overwritten in place, so a 2-element array keeps the default z.  We match
    that."""
    out = np.asarray(default, dtype=np.float32).copy()
    if isinstance(value, str):
        try:
            return np.asarray(_VECTOR_ALIASES[value], dtype=np.float32)
        except KeyError:
            raise ValueError(f"unknown vector alias '{value}'") from None
    if isinstance(value, bool):
        raise ValueError("no mapping from TOML boolean to vector")
    if isinstance(value, (int, float)):
        return np.full(3, float(value), dtype=np.float32)  # scalar broadcast
    seq = list(value)
    if len(seq) > 3:
        raise ValueError(f"vector array has {len(seq)} components (max 3)")
    for i, c in enumerate(seq):
        if not isinstance(c, (int, float)) or isinstance(c, bool):
            raise ValueError(f"bad vector component {c!r}")
        if isinstance(c, float) and not np.isfinite(c):
            raise ValueError("Infinities and NaNs are not allowed.")
        out[i] = float(c)
    return out


def _deser_material_type(value) -> int:
    """Enum by int or name (scene.cpp:383-405)."""
    if isinstance(value, bool):
        raise ValueError("no mapping from TOML boolean to material_type")
    if isinstance(value, int):
        if value not in _MATERIAL_NAMES:
            raise ValueError(f"integer value {value} was not a member of enum material_type")
        return value
    if isinstance(value, str):
        if value not in MATERIAL_TYPES:
            raise ValueError(f"string value '{value}' was not a member of enum material_type")
        return MATERIAL_TYPES[value]
    raise ValueError(f"no mapping from {value!r} to material_type")


def _deser_float(value, default: float, what: str = "value") -> float:
    if value is None:
        return default
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"no mapping from {value!r} to float ({what})")
    v = float(value)
    if not np.isfinite(v):
        raise ValueError("Infinities and NaNs are not allowed.")
    return v


def _deser_uint(value, default: int, what: str = "value") -> int:
    """toml++ ``deserialize(..., unsigned{})`` refuses negative integers
    (``node.value<unsigned>()`` bounds-checks and returns nullopt →
    mismatch_error, scene.cpp:88-101); match that rather than letting a
    negative index wrap via Python negative indexing."""
    if value is None:
        return default
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise ValueError(f"no mapping from {value!r} to unsigned ({what})")
    return int(value)


def loads(text: str, *, path: str = "", compat_colours: bool = True) -> Scene:
    """Parse a TOML scene document (semantics of scene.cpp:483-618).

    Loader errors carry best-effort TOML source positions, mirroring the
    reference's ``error(node, ...) << node.source()`` (scene.cpp:58-66)."""
    import contextlib
    import tomllib

    config = tomllib.loads(text)
    src = _SourceMap(text)

    @contextlib.contextmanager
    def _at(section=None, index=None, key=None):
        try:
            yield
        except ValueError as e:
            if "(error occurred at line" in str(e):
                raise
            pos = src.locate(section, index, key)
            if pos is None:
                raise
            raise ValueError(
                f"{e}\n\n(error occurred at line {pos[0]}, column {pos[1]})"
            ) from None

    with _at(key="samples_per_pixel"):
        spp = min(max(_deser_uint(config.get("samples_per_pixel"), 30, "samples_per_pixel"), 1), 1000)
    with _at(key="max_bounces"):
        max_bounces = min(max(_deser_uint(config.get("max_bounces"), 10, "max_bounces"), 1), 1000)

    cam_tbl = config.get("camera")
    if cam_tbl is not None:
        if not isinstance(cam_tbl, dict):
            with _at(section="camera"):
                raise ValueError(f"expected table at key 'camera', got {type(cam_tbl).__name__}")
        with _at(section="camera", key="position"):
            cam_pos = _deser_vec3(cam_tbl.get("position", (0.0, 1.0, 0.0)), (0.0, 1.0, 0.0))
        with _at(section="camera", key="direction"):
            cam_dir = _deser_vec3(cam_tbl.get("direction", "forward"), _VECTOR_ALIASES["forward"])
    else:
        cam_pos = np.array([0.0, 1.0, 0.0], dtype=np.float32)
        cam_dir = np.asarray(_VECTOR_ALIASES["forward"], dtype=np.float32)
    camera = Camera.from_pose(cam_pos, cam_dir)

    # materials (scene.cpp:540-566)
    names, types, albedos, roughs, refls = [], [], [], [], []
    for mi, tbl in enumerate(config.get("materials", ()) or ()):
        with _at(section="materials", index=mi, key="type"):
            mtype = _deser_material_type(tbl.get("type", "lambert"))
        default_refl = MATERIAL_DEFAULT_REFLECTIVITY.get(mtype, _DEFAULT_REFLECTIVITY_OTHER)
        names.append(str(tbl.get("name", "")))
        types.append(mtype)
        with _at(section="materials", index=mi, key="albedo"):
            albedos.append(resolve_colour(tbl.get("albedo", "fuchsia"), compat=compat_colours))
        default_rough = 0.0 if mtype == MATERIAL_TYPES["dielectric"] else 0.5
        with _at(section="materials", index=mi, key="roughness"):
            roughs.append(_deser_float(tbl.get("roughness"), default_rough, "roughness"))
        with _at(section="materials", index=mi, key="reflectivity"):
            refls.append(_deser_float(tbl.get("reflectivity"), default_refl, "reflectivity"))
    if not types:
        # fallback fuchsia lambert (scene.cpp:565-566)
        names, types = [""], [MATERIAL_TYPES["lambert"]]
        albedos = [resolve_colour("fuchsia", compat=compat_colours)]
        roughs, refls = [0.05], [0.5]

    n_mat = len(types)
    mb = _bucket(n_mat)
    materials = Materials(
        type=_t(_pad_rows(np.asarray(types, np.int32), mb)),
        albedo=_t(_pad_rows(np.asarray(albedos, np.float32), mb)),
        roughness=_t(_pad_rows(np.asarray(roughs, np.float32), mb)),
        reflectivity=_t(_pad_rows(np.asarray(refls, np.float32), mb)),
        count=n_mat,
        names=tuple(names),
    )

    def get_material(tbl, section, index) -> int:
        with _at(section=section, index=index, key="material"):
            m = _deser_uint(tbl.get("material"), 0, "material")
            if m >= n_mat:
                # scene.cpp:568-574
                raise ValueError(f"material index {m} out-of-range")
        return m

    # planes (scene.cpp:576-585)
    p_n, p_d, p_m = [], [], []
    for pi, tbl in enumerate(config.get("planes", ()) or ()):
        with _at(section="planes", index=pi, key="position"):
            pos = _deser_vec3(tbl.get("position", (0.0, 0.0, 0.0)), (0.0, 0.0, 0.0))
        with _at(section="planes", index=pi, key="normal"):
            nrm = _deser_vec3(tbl.get("normal", (0.0, 1.0, 0.0)), (0.0, 1.0, 0.0))
        nrm = nrm / np.linalg.norm(nrm)
        p_n.append(nrm)
        p_d.append(-float(np.dot(nrm, pos)))
        p_m.append(get_material(tbl, "planes", pi))
    pb = _bucket(len(p_n))
    planes = Planes(
        normal=_t(_pad_rows(np.asarray(p_n, np.float32).reshape(-1, 3), pb)),
        d=_t(_pad_rows(np.asarray(p_d, np.float32), pb, fill=1.0)),
        material=_t(_pad_rows(np.asarray(p_m, np.int32), pb)),
        count=len(p_n),
    )

    # spheres (scene.cpp:587-597)
    s_c, s_r, s_m = [], [], []
    for si, tbl in enumerate(config.get("spheres", ()) or ()):
        with _at(section="spheres", index=si, key="position"):
            s_c.append(_deser_vec3(tbl.get("position", (0.0, 1.0, -3.0)), (0.0, 1.0, -3.0)))
        with _at(section="spheres", index=si, key="radius"):
            s_r.append(_deser_float(tbl.get("radius"), 0.5, "radius"))
        s_m.append(get_material(tbl, "spheres", si))
    sb = _bucket(len(s_c))
    spheres = Spheres(
        center=_t(_pad_rows(np.asarray(s_c, np.float32).reshape(-1, 3), sb, fill=1e9)),
        radius=_t(_pad_rows(np.asarray(s_r, np.float32), sb, fill=0.0)),
        material=_t(_pad_rows(np.asarray(s_m, np.int32), sb)),
        count=len(s_c),
    )

    # boxes (scene.cpp:599-615)
    b_c, b_e, b_m = [], [], []
    for bi, tbl in enumerate(config.get("boxes", ()) or ()):
        with _at(section="boxes", index=bi, key="position"):
            b_c.append(_deser_vec3(tbl.get("position", (0.0, 1.0, -3.0)), (0.0, 1.0, -3.0)))
        with _at(section="boxes", index=bi, key="extents"):
            b_e.append(_deser_vec3(tbl.get("extents", 0.5), (0.5, 0.5, 0.5)))
        b_m.append(get_material(tbl, "boxes", bi))
    bb = _bucket(len(b_c))
    boxes = Boxes(
        center=_t(_pad_rows(np.asarray(b_c, np.float32).reshape(-1, 3), bb, fill=1e9)),
        extents=_t(_pad_rows(np.asarray(b_e, np.float32).reshape(-1, 3), bb, fill=0.0)),
        material=_t(_pad_rows(np.asarray(b_m, np.int32), bb)),
        count=len(b_c),
    )

    return Scene(
        camera=camera,
        materials=materials,
        spheres=spheres,
        planes=planes,
        boxes=boxes,
        samples_per_pixel=spp,
        max_bounces=max_bounces,
        path=path,
    )


def _resolve_scene_path(path: str) -> Optional[str]:
    """Search-prefix resolution (scene.cpp:496-525)."""
    if os.path.isabs(path):
        return path if os.path.isfile(path) else None
    for root in PATH_SEARCH_PREFIXES:
        p = os.path.join(root, path) if root else path
        if os.path.isfile(p):
            return p
    return None


def load(path: str, *, compat_colours: bool = True) -> Scene:
    """Load a scene file (scene.cpp:483-529): '-' reads stdin; relative paths
    are resolved against the search prefixes."""
    if not path:
        raise FileNotFoundError("no scene file path provided")
    if path == "-":
        return loads(sys.stdin.read(), path="", compat_colours=compat_colours)
    resolved = _resolve_scene_path(path)
    if resolved is None:
        raise FileNotFoundError(f"scene path '{path}' did not exist or was not a file")
    with io.open(resolved, "r", encoding="utf-8") as f:
        return loads(f.read(), path=resolved, compat_colours=compat_colours)


def load_first_available(*, compat_colours: bool = True) -> Scene:
    """First *.toml found under the search prefixes (scene.cpp:620-643)."""
    for root in PATH_SEARCH_PREFIXES:
        d = root or "."
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".toml") and os.path.isfile(os.path.join(d, name)):
                return load(os.path.join(d, name), compat_colours=compat_colours)
    raise FileNotFoundError("no scene files found")


def make_procedural_scene(
    n_spheres: int,
    *,
    seed: int = 0,
    spp: int = 128,
    max_bounces: int = 8,
    camera_position=(0.0, 2.0, 12.0),
    camera_direction=(0.0, -0.1, -1.0),
) -> Scene:
    """Procedural N-sphere benchmark scene (BASELINE.json configs 4 & 5):
    a ground sphere plus N-1 random spheres with mixed materials."""
    rng = np.random.default_rng(seed)
    n_small = max(n_spheres - 1, 0)

    mats_t = [MATERIAL_TYPES["lambert"], MATERIAL_TYPES["metal"], MATERIAL_TYPES["dielectric"]]
    n_mat = 12
    types = [mats_t[i % 3] for i in range(n_mat)]
    albedos = np.clip(rng.uniform(0.1, 1.0, size=(n_mat, 4)), 0, 1).astype(np.float32)
    albedos[:, 3] = 1.0
    roughs = rng.uniform(0.0, 0.4, size=n_mat).astype(np.float32)
    refls = np.asarray(
        [MATERIAL_DEFAULT_REFLECTIVITY.get(t, _DEFAULT_REFLECTIVITY_OTHER) for t in types],
        np.float32,
    )
    mb = _bucket(n_mat)
    materials = Materials(
        type=_t(_pad_rows(np.asarray(types, np.int32), mb)),
        albedo=_t(_pad_rows(albedos, mb)),
        roughness=_t(_pad_rows(roughs, mb)),
        reflectivity=_t(_pad_rows(refls, mb)),
        count=n_mat,
        names=tuple(f"m{i}" for i in range(n_mat)),
    )

    side = int(np.ceil(np.sqrt(n_small))) if n_small else 1
    xs, zs = np.meshgrid(np.arange(side), np.arange(side))
    grid = np.stack([xs.ravel(), zs.ravel()], axis=-1)[:n_small].astype(np.float32)
    spacing = 1.6
    centers = np.zeros((n_small + 1, 3), np.float32)
    radii = np.zeros(n_small + 1, np.float32)
    mat_idx = np.zeros(n_small + 1, np.int32)
    centers[0] = (0.0, -1000.0, 0.0)
    radii[0] = 1000.0
    mat_idx[0] = 0
    if n_small:
        r = rng.uniform(0.15, 0.45, size=n_small).astype(np.float32)
        jitter = rng.uniform(-0.4, 0.4, size=(n_small, 2)).astype(np.float32)
        centers[1:, 0] = (grid[:, 0] - side / 2) * spacing + jitter[:, 0]
        centers[1:, 2] = -(grid[:, 1]) * spacing + jitter[:, 1]
        centers[1:, 1] = r
        radii[1:] = r
        mat_idx[1:] = rng.integers(0, n_mat, size=n_small)

    sbk = _bucket(n_spheres)
    spheres = Spheres(
        center=_t(_pad_rows(centers, sbk, fill=1e9)),
        radius=_t(_pad_rows(radii, sbk, fill=0.0)),
        material=_t(_pad_rows(mat_idx, sbk)),
        count=n_spheres,
    )
    planes = Planes(
        normal=torch.zeros((_MIN_BUCKET, 3), dtype=torch.float32),
        d=torch.ones(_MIN_BUCKET, dtype=torch.float32),
        material=torch.zeros(_MIN_BUCKET, dtype=torch.int32),
        count=0,
    )
    boxes = Boxes(
        center=torch.full((_MIN_BUCKET, 3), 1e9, dtype=torch.float32),
        extents=torch.zeros((_MIN_BUCKET, 3), dtype=torch.float32),
        material=torch.zeros(_MIN_BUCKET, dtype=torch.int32),
        count=0,
    )
    return Scene(
        camera=Camera.from_pose(camera_position, camera_direction),
        materials=materials,
        spheres=spheres,
        planes=planes,
        boxes=boxes,
        samples_per_pixel=spp,
        max_bounces=max_bounces,
        path=f"<procedural:{n_spheres}>",
    )
