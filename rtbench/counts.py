"""The least time of a frame's or a step's work on one H100: operation
counts per unit of live work and the published peaks.

A frozen copy of ``chip_smoke.py:363-391`` (``PEAK_*``, ``OPS``) and
``chip_smoke.py:520-561`` (``forward_ops``, ``reverse_ops``, ``bound``):
operations counted by hand from ``rt_tpu_torch/csrc/trace.cuh`` and
``bounce.cuh`` per unit of live work (an add, multiply, compare, select,
min/max, conversion, division or square root counts one; the integer hash
is not FP32 work).  The live work itself is counted by the reference's own
trace of the same inputs (``rtbench.reference``), never by the program.

The counts are of the linear scan, the semantics of the renderer the
program is modelled on (every live ray tests every sphere row; no
bounding-volume hierarchy).  A program that culls primitives would read
over 100% by construction: the counts have to be redone before such a
change can be judged.
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet): HBM 3.35 TB/s; FP32 67 TFLOP/s counting an
# FMA as two operations, 33.5 T operations/s without FMAs (the kernels are
# built with --fmad=false)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 33.5e12

OPS = dict(raygen=40, scan_plane=20, scan_sphere_reject=17, scan_sphere_hit=9, fwd_miss=12,
           fwd_hit=35, fwd_sphere=14, fwd_lambert=14, fwd_metal=37, fwd_dielectric=71,
           rev_live=50, rev_miss=20, rev_sphere=128, rev_plane=60, rev_lambert=34, rev_metal=83,
           rev_dielectric=166, raygen_adjoint=70, loss=15)


def forward_ops(work: dict, n_spheres: int, n_planes: int) -> int:
    """FP32 operations of the forward on this live work: raygen, the scan
    of every row by every live bounce (a sphere row's root work only where
    disc >= 0), and the hit or miss work."""
    hits = work["sphere"] + work["plane"]
    return (work["rays"] * OPS["raygen"]
            + work["live"] * (n_planes * OPS["scan_plane"] + n_spheres * OPS["scan_sphere_reject"])
            + (work["disc_pairs"] * OPS["scan_sphere_hit"] if n_spheres else 0)
            + work["miss"] * OPS["fwd_miss"] + hits * OPS["fwd_hit"]
            + work["sphere"] * OPS["fwd_sphere"] + work["lambert"] * OPS["fwd_lambert"]
            + work["metal"] * OPS["fwd_metal"] + work["dielectric"] * OPS["fwd_dielectric"])


def reverse_ops(work: dict) -> int:
    """FP32 operations of the reverse (every gradient slot the kernels
    compute) on this live work."""
    return (work["rays"] * (OPS["raygen"] + OPS["raygen_adjoint"])
            + work["live"] * OPS["rev_live"] + work["miss"] * OPS["rev_miss"]
            + work["sphere"] * OPS["rev_sphere"] + work["plane"] * OPS["rev_plane"]
            + work["lambert"] * OPS["rev_lambert"] + work["metal"] * OPS["rev_metal"]
            + work["dielectric"] * OPS["rev_dielectric"])


def frame_cost(work: dict, n_spheres: int, n_pix: int) -> tuple[int, int]:
    """``(bytes, operations)`` a frame must move and compute: the sphere
    rows (centre, radius, material: 20 bytes) and the camera read once,
    the (H, W, 3) float32 frame written once."""
    return 20 * n_spheres + 64 + 12 * n_pix, forward_ops(work, n_spheres, 0)


def step_cost(work: dict, n_spheres: int, n_pix: int, n_mat: int) -> tuple[int, int]:
    """``(bytes, operations)`` of a training step: the sphere rows, the
    camera and the (H, W, 3) target read once, the material gradient
    written once; the forward, the loss and the reverse."""
    return (20 * n_spheres + 64 + 12 * n_pix + 16 * n_mat,
            forward_ops(work, n_spheres, 0) + reverse_ops(work) + n_pix * OPS["loss"])


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """The least milliseconds for these bytes and operations."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S) * 1e3
