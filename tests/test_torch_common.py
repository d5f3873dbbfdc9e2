"""Shared inputs and tolerances of the ``test_torch_*`` files.  Imports
neither JAX nor the JAX package, so that the card-only tests
(test_torch_cuda.py) run where JAX is not installed."""

import pathlib

import numpy as np
import torch

SCENES = pathlib.Path(__file__).resolve().parent.parent / "scenes"

# rt_tpu's own tolerance between two of its kernels (pallas_wavefront.py:37-39)
ATOL = 2e-5
# Share of pixels allowed beyond ATOL.  XLA's CPU backend contracts a*b+c
# into FMAs and torch's CPU sqrt is not correctly rounded, so a ray that
# grazes a silhouette can take the other branch and its pixel differs by
# far more than ATOL; every other pixel agrees to float rounding.
MAX_SHARE = 0.005

PLANES_TOML = """
materials = [ { type = 'lambert', albedo = 'red' },
              { type = 'metal',   albedo = 'white', roughness = 0.1 } ]
planes  = [ { material = 0 } ]
spheres = [ { material = 1, position = [0.0, 1.0, -3.0], radius = 0.5 } ]
"""
BOX_TOML = ("\nboxes = [ { material = 2, position = [-1, 0.5, 0.3], "
            "extents = [0.3, 0.5, 0.3] } ]\n")


def assert_frames_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    diff = np.abs(got - want)
    bad = (diff > ATOL).any(axis=-1)
    assert bad.mean() <= MAX_SHARE, (
        f"{bad.sum()} of {bad.size} pixels differ by more than {ATOL} "
        f"(max abs diff {diff.max()})")

# tests/test_replay.py's box scene (a ground sphere, a lambert and a metal box)
REPLAY_BOX_TOML = (
    "samples_per_pixel = 2\n"
    "max_bounces = 4\n"
    "materials = [ { type = 'lambert', albedo = 'gray' },\n"
    "              { type = 'metal', albedo = 'white', roughness = 0.1 },\n"
    "              { type = 'lambert', albedo = 'red' } ]\n"
    "spheres = [ { material = 0, position = [0,-1000,0], radius = 1000 } ]\n"
    "boxes = [ { material = 2, position = [0, 0.5, -3], extents = [0.5, 0.5, 0.5] },\n"
    "          { material = 1, position = [1.6, 0.4, -3.5], extents = [0.4, 0.4, 0.4] } ]\n"
)


def box_scene_toml(n_spheres: int, n_boxes: int) -> str:
    """tests/test_pallas_blockwise.py's ``_box_scene_toml`` generator: a red
    lambert ground plane, then spheres and boxes alternating lambert and
    metal, their positions and sizes from numpy seed 9 (660 spheres and 24
    boxes: past the render kernel's 640 primitives)."""
    rng = np.random.default_rng(9)
    lines = [
        "samples_per_pixel = 1",
        "max_bounces = 2",
        "materials = [ { type = 'lambert', albedo = 'red' },",
        "              { type = 'metal', albedo = [0.9,0.9,0.9], roughness = 0.1 } ]",
        "planes  = [ { material = 0, position = [0,0,0], normal = 'up' } ]",
    ]
    sph = ["{ material = %d, position = [%.3f, %.3f, %.3f], radius = %.3f }"
           % (i % 2, x, y, z, r)
           for i, (x, y, z, r) in enumerate(zip(
               rng.uniform(-6, 6, n_spheres), rng.uniform(0.2, 2, n_spheres),
               rng.uniform(-9, -3, n_spheres), rng.uniform(0.1, 0.4, n_spheres)))]
    if sph:
        lines.append("spheres = [ " + ",\n  ".join(sph) + " ]")
    box = ["{ material = %d, position = [%.3f, %.3f, %.3f], extents = [%.3f, %.3f, %.3f] }"
           % (i % 2, x, y, z, ex, ey, ez)
           for i, (x, y, z, ex, ey, ez) in enumerate(zip(
               rng.uniform(-6, 6, n_boxes), rng.uniform(0.2, 2, n_boxes),
               rng.uniform(-9, -3, n_boxes), rng.uniform(0.1, 0.5, n_boxes),
               rng.uniform(0.1, 0.5, n_boxes), rng.uniform(0.1, 0.5, n_boxes)))]
    lines.append("boxes = [ " + ",\n  ".join(box) + " ]")
    return "\n".join(lines)


def tiles_to_flat(a, n: int) -> np.ndarray:
    """A JAX record-kernel output laid out (tiles, CH, rows, 128) as (CH, n)
    (pallas_render.records_to_flat's reshape)."""
    a = np.asarray(a)
    t, ch, r, lanes = a.shape
    return a.transpose(1, 0, 2, 3).reshape(ch, t * r * lanes)[:, :n]


def assert_records_match(recs, jrecs, n: int, min_share: float = 1 - MAX_SHARE):
    """The port's raw records against a JAX record kernel's: on the lanes
    that are live at a bounce's entry, kind, idx and the bits word equal on
    at least ``min_share`` of them (XLA's CPU backend contracts FMAs, which
    can flip a grazing hit; on dead lanes the JAX kernels write what their
    dense lanes happen to compute, the port 0); the unit vectors, coins and
    jitter within 1e-6 everywhere."""
    live = (tiles_to_flat(jrecs["bits"], n).astype(np.int32) & 16) > 0
    assert live.any()
    for k in ("kind", "idx", "bits"):
        got = recs[k].numpy()
        want = tiles_to_flat(jrecs[k], n).astype(np.int32)
        assert got.shape == want.shape and got.dtype == np.int32, k
        share = (got == want)[live].mean()
        assert share >= min_share, f"{k}: {share:.4f} of live lanes equal"
        assert (got[~live] == 0).all(), k
    for k in ("urx", "ury", "urz", "coin", "jitter"):
        np.testing.assert_allclose(recs[k].numpy(), tiles_to_flat(jrecs[k], n), rtol=0,
                                   atol=1e-6, err_msg=k)


def tie_scene_toml() -> str:
    """A scene whose closest-hit scans tie often: a ground plane, 12 spheres
    each on two adjacent rows and all 12 again at the end of the table (the
    split scan puts the copies in other lanes), a ground sphere whose top
    touches the plane, and two equal boxes (with ``--boxes``)."""
    rng = np.random.default_rng(11)
    sph = ["{ material = %d, position = [%.3f, %.3f, %.3f], radius = %.3f }" % (i % 3, x, y, z, r)
           for i, (x, y, z, r) in enumerate(zip(
               rng.uniform(-2, 2, 12), rng.uniform(0.3, 1.2, 12), rng.uniform(-4, -1, 12),
               rng.uniform(0.2, 0.5, 12)))]
    rows = [s for s in sph for _ in (0, 1)] + sph
    rows.append("{ material = 0, position = [0, -1000, 0], radius = 1000 }")
    box = "{ material = 1, position = [1.2, 0.4, -2.0], extents = [0.3, 0.4, 0.3] }"
    return "\n".join([
        "camera = { position = [0, 1, 3], direction = 'forward' }",
        "materials = [ { type = 'lambert', albedo = 'gray' },",
        "              { type = 'metal', albedo = 'white', roughness = 0.05 },",
        "              { type = 'dielectric', albedo = 'white' } ]",
        "planes = [ { material = 0, position = [0, 0, 0], normal = 'up' } ]",
        "spheres = [ " + ",\n  ".join(rows) + " ]",
        f"boxes = [ {box}, {box} ]",
    ])


def grazing_scene_toml() -> str:
    """A scene whose rays graze spheres often: the camera 5 cm above the
    top of a radius-1000 ground sphere, looking along it, and 40 small
    spheres resting on it (lambert and metal), so that the rows near the
    horizon and the spheres' silhouettes have disc near 0."""
    rng = np.random.default_rng(13)
    rows = ["{ material = %d, position = [%.4f, %.4f, %.4f], radius = %.4f }" % (i % 2, x, r, z, r)
            for i, (x, z, r) in enumerate(zip(rng.uniform(-2, 2, 40), rng.uniform(-8, -1, 40),
                                              rng.uniform(0.01, 0.06, 40)))]
    rows.append("{ material = 1, position = [0, -1000, 0], radius = 1000 }")
    return "\n".join([
        "camera = { position = [0, 0.05, 3], direction = 'forward' }",
        "materials = [ { type = 'lambert', albedo = 'gray' },",
        "              { type = 'metal', albedo = 'white', roughness = 0.02 } ]",
        "spheres = [ " + ",\n  ".join(rows) + " ]",
    ])


# most camera rays miss: few rays live after bounce 0
SKY_TOML = """
camera = { position = [0, 1, 3], direction = 'forward' }
materials = [ { type = 'lambert', albedo = 'gray' }, { type = 'metal', albedo = 'white' } ]
spheres = [ { material = 0, position = [0, 0.8, -4], radius = 0.3 },
            { material = 1, position = [0.5, 1.0, -4.5], radius = 0.2 } ]
"""
