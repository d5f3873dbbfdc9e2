"""The inputs a run hands to the program and to the reference alike.

Everything here is made by the benchmark, from a configuration file and
``--seed``; nothing is read from the program.  The scene generator is a
frozen copy of ``rt_tpu_torch/scene.py:643-724`` (``make_procedural_scene``)
that returns plain arrays; ``rtbench/tests/test_reference.py`` holds it to
the program's own generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# material_type enum, rt_tpu_torch/scene.py:45-54
LAMBERT_T, METAL_T, DIELECTRIC_T = 0, 1, 2
# per-type default reflectivity (IOR for the dielectric family), scene.py:58-65
_DEFAULT_REFLECTIVITY = {METAL_T: 0.8, DIELECTRIC_T: 1.52}
_DEFAULT_REFLECTIVITY_OTHER = 0.5
_MIN_BUCKET = 8


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _pad(a: np.ndarray, rows: int, fill=0.0) -> np.ndarray:
    extra = rows - a.shape[0]
    if extra <= 0:
        return a
    return np.concatenate([a, np.full((extra,) + a.shape[1:], fill, a.dtype)])


def procedural_scene(n_spheres: int, seed: int = 0, camera_position=(0.0, 2.0, 12.0),
                     camera_direction=(0.0, -0.1, -1.0)) -> dict:
    """A ground sphere and ``n_spheres - 1`` spheres on a jittered grid with
    12 mixed materials, as padded numpy tables (scene.py:643-724).

    Keys: ``mat_type`` (M,) int32, ``albedo`` (M, 4), ``roughness`` (M,),
    ``reflectivity`` (M,) float32, ``n_mat``; ``center`` (S, 3),
    ``radius`` (S,) float32, ``material`` (S,) int32, ``n_spheres``;
    ``camera_position``, ``camera_direction`` (3,) float32."""
    rng = np.random.default_rng(seed)
    n_small = max(n_spheres - 1, 0)
    n_mat = 12
    types = [(LAMBERT_T, METAL_T, DIELECTRIC_T)[i % 3] for i in range(n_mat)]
    albedo = np.clip(rng.uniform(0.1, 1.0, size=(n_mat, 4)), 0, 1).astype(np.float32)
    albedo[:, 3] = 1.0
    rough = rng.uniform(0.0, 0.4, size=n_mat).astype(np.float32)
    refl = np.asarray([_DEFAULT_REFLECTIVITY.get(t, _DEFAULT_REFLECTIVITY_OTHER) for t in types],
                      np.float32)
    side = int(np.ceil(np.sqrt(n_small))) if n_small else 1
    xs, zs = np.meshgrid(np.arange(side), np.arange(side))
    grid = np.stack([xs.ravel(), zs.ravel()], axis=-1)[:n_small].astype(np.float32)
    centers = np.zeros((n_small + 1, 3), np.float32)
    radii = np.zeros(n_small + 1, np.float32)
    mat = np.zeros(n_small + 1, np.int32)
    centers[0] = (0.0, -1000.0, 0.0)
    radii[0] = 1000.0
    if n_small:
        r = rng.uniform(0.15, 0.45, size=n_small).astype(np.float32)
        jitter = rng.uniform(-0.4, 0.4, size=(n_small, 2)).astype(np.float32)
        centers[1:, 0] = (grid[:, 0] - side / 2) * 1.6 + jitter[:, 0]
        centers[1:, 2] = -(grid[:, 1]) * 1.6 + jitter[:, 1]
        centers[1:, 1] = r
        radii[1:] = r
        mat[1:] = rng.integers(0, n_mat, size=n_small)
    mb, sb = _bucket(n_mat), _bucket(n_spheres)
    return {
        "mat_type": _pad(np.asarray(types, np.int32), mb), "albedo": _pad(albedo, mb),
        "roughness": _pad(rough, mb), "reflectivity": _pad(refl, mb), "n_mat": n_mat,
        "center": _pad(centers, sb, 1e9), "radius": _pad(radii, sb), "material": _pad(mat, sb),
        "n_spheres": n_spheres,
        "camera_position": np.asarray(camera_position, np.float32),
        "camera_direction": np.asarray(camera_direction, np.float32),
    }


def scene_arrays(config: dict) -> dict:
    """The configuration's scene (``config["scene"]``) as arrays."""
    sc = config["scene"]
    if sc["kind"] != "procedural":
        raise ValueError(f"unknown scene kind {sc['kind']!r}")
    return procedural_scene(sc["spheres"], sc["seed"], sc["camera_position"],
                            sc["camera_direction"])


class SeedStream:
    """The seeds of a run's frames or steps, in order: distinct
    non-negative int32 values drawn from ``seed``, in batches as the run
    needs them.  Unit i of a run always gets the i-th, so two runs of one
    seed do the same work."""

    def __init__(self, seed: int):
        self._gen = np.random.default_rng(
            np.random.SeedSequence([seed % 2**32, (seed // 2**32) % 2**32, 17]))
        self._seen, self._queue = set(), []

    def __next__(self) -> int:
        while not self._queue:
            for x in self._gen.integers(0, 2**31 - 1, size=1024).tolist():
                if x not in self._seen:
                    self._seen.add(x)
                    self._queue.append(x)
            self._queue.reverse()
        return self._queue.pop()

    def __iter__(self):
        return self


def target_image(size, seed: int, device, cells=(16, 9)) -> torch.Tensor:
    """A pre-gamma (H, W, 3) float32 training target on ``device``: a
    ``cells``-sized grid of random colours in [0.05, 0.6) drawn from
    ``seed`` by one device generator, bilinearly upsampled in one call."""
    w, h = size
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    cw, ch = cells
    low = torch.rand((1, 3, ch, cw), generator=gen, device=device) * 0.55 + 0.05
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return img[0].permute(1, 2, 0).contiguous()


def pixel_sample(n_pix: int, count: int, seed: int) -> torch.Tensor:
    """``count`` distinct pixel ids of a frame drawn from ``seed``, sorted
    (int64, on the CPU)."""
    g = torch.Generator()
    g.manual_seed((seed * 1000003 + 7) & (2**63 - 1))
    return torch.sort(torch.randperm(n_pix, generator=g)[:min(count, n_pix)]).values


VFOV = float(math.pi / 4)
NEAR = 0.01
