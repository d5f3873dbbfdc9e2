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
