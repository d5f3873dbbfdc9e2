"""The scene-to-card input format: the primitive tables every kernel of the
port reads, the camera vector, and the copies from the host to the card.

Rows.  A sphere or a plane is one row of 10 float32 columns with its
material payload baked in, ``[cx/nx, cy/ny, cz/nz, r/d, alb_r, alb_g,
alb_b, refl, rough, cls]`` (``cls`` the BRDF class of the material's type
under the personality); a box of the ``--boxes`` extension is one row of
12, ``[cx, cy, cz, ex, ey, ez, alb_r, alb_g, alb_b, refl, rough, cls]``.
:func:`_flatten` gives them as the JAX package's columns.

Two layouts of those rows:

* unrolled (the render kernel, its record form and the fused gradient
  kernels of ``ops.grad``): the used rows only, (count, 10) and (count, 12)
  (:func:`_unrolled_tables`);
* padded (the blockwise and wavefront kernels): (bucket, 16) tables, the
  height from :func:`_bucket`, padding rows zero, read with the used-row
  counts beside them.  :func:`_padded_tables` builds them from a scene on
  the host and writes each row's index into the first unused column (10;
  12 for boxes: the JAX tie-break column of a Morton-sorted table, which
  no kernel here reads); :func:`_param_tables` rebuilds them on the card
  from parameter tensors and leaves that column zero, as JAX's
  ``_tables_jnp`` does.

The serve routes build from the scene on the host for each frame (numpy,
one pinned upload a table); the train routes rebuild from the parameters
already on the card for each step (torch ops, no upload).  Either build
runs inside the span ``rt.tables``, and every upload inside ``rt.upload``.
The camera vector (:func:`_pack_camera`) is 16 float32: the position, the
row-major rotation, then :func:`_camera_tail`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..diff import apply_params
from ..materials import personality_classes
from ..profiling import span

MAX_BLOCKWISE_PRIMS = 16384  # the JAX kernel's cap (a (16384, 16) f32 table is 1 MB)
_COLS = 16                   # padded row length (10 used; 12 for boxes)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _bucket(n: int) -> int:
    """A padded table's height for ``n`` rows: at least 128, then
    multiples of 512 (pallas_blockwise ``_bucket``)."""
    if n <= 128:
        return 128
    return -(-n // 512) * 512


def _flatten(scene, personality: str, include_boxes: bool = False):
    """The scene's rows as columns, ``(s_cols, p_cols, b_cols)`` float32:
    (10, n_spheres), (10, n_planes) and (12, n_boxes), the used entries
    only (the scene's own padding is dropped); ``b_cols`` is (12, 0)
    unless ``include_boxes``.  ``s_cols, p_cols`` are pallas_render's
    ``_flatten_primitives`` and ``b_cols`` its ``_flatten_boxes``."""
    classes = _np(personality_classes(personality))
    mat_t = _np(scene.materials.type)
    alb = _np(scene.materials.albedo)
    refl = _np(scene.materials.reflectivity)
    rough = _np(scene.materials.roughness)

    def build(geom, material, count):  # geom: the geometry columns, one array each
        cols = np.zeros((len(geom) + 6, count), np.float32)
        if count:
            m = _np(material)[:count]
            for i, g in enumerate(geom):
                cols[i] = g[:count]
            cols[-6:-3] = alb[m][:, :3].T
            cols[-3] = refl[m]
            cols[-2] = rough[m]
            cols[-1] = classes[mat_t[m]]
        return cols

    sp, pl, bx = scene.spheres, scene.planes, scene.boxes
    s_cols = build([*_np(sp.center).T, _np(sp.radius)], sp.material, sp.count)
    p_cols = build([*_np(pl.normal).T, _np(pl.d)], pl.material, pl.count)
    b_cols = (build([*_np(bx.center).T, *_np(bx.extents).T], bx.material, bx.count)
              if include_boxes else np.zeros((12, 0), np.float32))
    return s_cols, p_cols, b_cols


def _pad(cols: np.ndarray) -> np.ndarray:
    """(used, count) columns -> the (bucket, 16) row-major table, each
    row's index in column ``used``."""
    used, count = cols.shape
    rows = _bucket(count)
    out = np.zeros((rows, _COLS), np.float32)
    out[:count, :used] = cols.T
    out[:, used] = np.arange(rows, dtype=np.float32)
    return out


def _unrolled_tables(scene, personality: str, include_boxes: bool, dev):
    """The render kernel's tables on ``dev``: ``(spheres, planes, boxes)``,
    (S, 10), (P, 10) and (B, 12) float32; B = 0 unless ``include_boxes``
    (0 boxes leaves boxes untested: the reference's box stub)."""
    with span("rt.tables"):
        return tuple(_upload(c.T, dev) for c in _flatten(scene, personality, include_boxes))


def _padded_tables(scene, personality: str, include_boxes: bool, dev):
    """The blockwise kernels' tables on ``dev`` and their counts:
    ``(spheres, planes, boxes, (n_spheres, n_planes, n_boxes))``.  The box
    table has 0 rows, and n_boxes is 0, unless ``include_boxes`` and the
    scene has boxes."""
    with span("rt.tables"):
        cols = _flatten(scene, personality, include_boxes)
        tabs = [_pad(c) for c in cols[:2]]
        tabs.append(_pad(cols[2]) if cols[2].shape[1] else np.zeros((0, _COLS), np.float32))
        return (*(_upload(t, dev) for t in tabs), tuple(c.shape[1] for c in cols))


def bw_grad_supported(scene) -> bool:
    """Whether the blockwise gradient step takes this scene: at most
    ``MAX_BLOCKWISE_PRIMS`` spheres and planes, and no boxes (the
    tables :func:`_param_tables` rebuilds hold no boxes)."""
    return (scene.spheres.count + scene.planes.count <= MAX_BLOCKWISE_PRIMS
            and scene.boxes.count == 0)


def _param_tables(scene, personality: str, size, device):
    """The twin of JAX's ``_tables_jnp`` at the scene's buckets:
    ``build(params) -> (s_tab, p_tab, cam)``, the padded (bucket, 16)
    tables and the camera vector rebuilt on ``device`` from the parameter
    tensors with torch ops — no host round trip and no upload per call.
    Material indices and classes, which never train, are looked up once
    here; ``build`` writes into the same two tables each call.  Raises
    unless :func:`bw_grad_supported`."""
    if not bw_grad_supported(scene):
        raise ValueError("scene exceeds the blockwise grad kernel limits "
                         f"({MAX_BLOCKWISE_PRIMS} spheres and planes, no boxes)")
    sc0 = scene.to(device)
    dev = sc0.spheres.center.device  # with its index
    classes = personality_classes(personality).to(dev)
    ns, npl = scene.spheres.count, scene.planes.count
    s_m = sc0.spheres.material[:ns].long()
    p_m = sc0.planes.material[:npl].long()
    s_cls = classes[sc0.materials.type[s_m].long()].float()
    p_cls = classes[sc0.materials.type[p_m].long()].float()
    tail = _upload(_camera_tail(scene.camera, size), dev)
    s_tab = torch.zeros((_bucket(ns), _COLS), dtype=torch.float32, device=dev)
    p_tab = torch.zeros((_bucket(npl), _COLS), dtype=torch.float32, device=dev)

    def rows(geom, d, m, cls, mats):
        return torch.cat([geom, d[:, None], mats.albedo[m][:, :3], mats.reflectivity[m][:, None],
                          mats.roughness[m][:, None], cls[:, None]], dim=1)

    def build(params):
        for k, v in params.items():
            if v.device != dev:
                raise ValueError(f"param {k} is on {v.device}, the step on {dev}")
        with span("rt.tables"), torch.no_grad():
            sc = apply_params(sc0, {k: v.detach() for k, v in params.items()})
            if ns:
                s_tab[:ns, :10] = rows(sc.spheres.center[:ns], sc.spheres.radius[:ns], s_m,
                                       s_cls, sc.materials)
            if npl:
                p_tab[:npl, :10] = rows(sc.planes.normal[:npl], sc.planes.d[:npl], p_m, p_cls,
                                        sc.materials)
            cam = torch.cat([sc.camera.position.float(), sc.camera.rotation.float().reshape(-1),
                             tail])
        return s_tab, p_tab, cam

    return build


def _camera_tail(camera, size) -> np.ndarray:
    """The camera vector's last 4 floats: tan(vfov/2), w/h and near
    computed in float64 and rounded to float32, then 0
    (pallas_render.py:833-839)."""
    w, h = size
    return np.asarray([np.tan(camera.vfov * 0.5), w / h, camera.near, 0.0], np.float32)


def _pack_camera(camera, size) -> np.ndarray:
    """The 16-float camera vector: position, row-major rotation, then
    :func:`_camera_tail`."""
    return np.concatenate([
        _np(camera.position).astype(np.float32),
        _np(camera.rotation).astype(np.float32).reshape(-1),
        _camera_tail(camera, size),
    ])


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available "
                           "(pass device='cpu' for the plain PyTorch version)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array → tensor on ``dev``; a CUDA copy goes through pinned
    memory without blocking the host."""
    with span("rt.upload"):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t


def _check(fn, name, t, dtype, shape, device):
    """A kernel wrapper's input ``name`` of ``fn``: a contiguous ``dtype``
    tensor on ``device`` of ``shape`` (None: any length), or raise."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")


def _check_tables(fn, tables, counts, dev):
    """The padded tables: contiguous (rows, 16) float32 on ``dev``, each
    count within its table and the total within the cap."""
    for name, t, c in zip(("spheres", "planes", "boxes"), tables, counts):
        _check(fn, name, t, torch.float32, (None, _COLS), dev)
        if not 0 <= c <= t.shape[0]:
            raise ValueError(f"{fn}: {c} {name} for a table of {t.shape[0]} rows")
    if sum(counts) > MAX_BLOCKWISE_PRIMS:
        raise ValueError(f"{fn}: more than {MAX_BLOCKWISE_PRIMS} primitives")
