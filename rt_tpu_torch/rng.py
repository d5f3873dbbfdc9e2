"""Counter-based random streams (port of ``rt_tpu.rng``).

The JAX package draws from JAX's threefry2x32 with partitionable keys: one
base key, folded per (sample, chunk, bounce), then a single ``uniform``
draw per step feeds every ray at once.  This module computes the same
stream with torch integer ops, so that a frame or a gradient of the port
can be compared with the JAX package's draw for draw.

* A key is host data: a pair of Python ints (two 32-bit words),
  ``make_key(s) = (0, s & 0xFFFFFFFF)``.  :func:`fold` is threefry2x32 of
  the key on the counter ``(0, d & 0xFFFFFFFF)``, scalar work on the host:
  no device launch and no synchronisation.
* :func:`random_bits` runs threefry2x32 of the key on the counters
  ``(i >> 32, i & 0xFFFFFFFF)`` of the flat index ``i`` on the tensor's
  device, in int64, and XORs the two output words (JAX's partitionable
  ``random_bits``).
* :func:`uniform` is ``((bits >> 9) | 0x3F800000)`` viewed as float32,
  minus 1: ``jax.random.uniform`` bit for bit.
* :func:`unit_vector` with ``mode="reference"`` normalises a U[0,1)^3
  sample (the reference's positive-octant biased ``random_unit_vector()``,
  random.hpp:57-66) with :func:`rt_tpu_torch.camera._norm3`, which rounds
  as ``jnp.linalg.norm`` does on the CPU: bit for bit with the JAX
  package.  ``mode="sphere"`` normalises a Gaussian sample,
  :func:`normal`, which follows ``jax.random.normal``: uniform on
  [nextafter(-1, 0), 1), then sqrt(2) * erfinv with XLA's float32 erfinv
  polynomial (Giles).  ``torch.erfinv`` is up to 86 ulp away from it; the
  polynomial here is held to ``jax.random.normal`` within a few ulp
  (``tests/test_torch_rng.py`` states the tolerance), because ``log1p``
  is not XLA's.

Every function that makes a tensor takes ``device`` and defaults to the
card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .camera import _fma32, _norm3

__all__ = ["make_key", "fold", "random_bits", "uniform", "normal", "unit_vector"]

_M32 = 0xFFFFFFFF
# threefry2x32's rotations (two alternating groups of four rounds) and its
# key-schedule parity constant (Salmon et al. 2011; jax._src.prng)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, d):
    return ((v << d) | (v >> (32 - d))) & _M32


def _threefry2x32(key, x0, x1):
    """threefry2x32 of the key (two ints) on the counter words ``x0``,
    ``x1`` (ints, or int64 tensors holding values in [0, 2^32)): five groups
    of four rounds with a key injection after each.  Returns the two output
    words, of the counters' type."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def make_key(seed: int = 0) -> tuple[int, int]:
    """The key of ``seed``, as ``jax.random.key(seed)`` holds it."""
    return (0, int(seed) & _M32)


def fold(key, *ids) -> tuple[int, int]:
    """The subkey that folds in a chain of integer identifiers (bounce,
    sample, chunk, ...), as ``jax.random.fold_in`` does one at a time."""
    for i in ids:
        key = _threefry2x32(key, 0, int(i) & _M32)
    return key


def _is_key(key) -> bool:
    return isinstance(key[0], int)


def random_bits(key, n: int, *, device="cuda") -> torch.Tensor:
    """(n,) int64 tensor of 32-bit words: JAX's partitionable threefry
    ``random_bits`` of ``key`` for a flat shape of n elements.

    ``key`` may also be a list of keys: then (len(key), n), row k the words
    of key k, all in one pass of torch ops (the keys go to the device as
    one small tensor)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    if not _is_key(key):
        words = torch.tensor(key, dtype=torch.int64).reshape(-1, 2)
        if i.device.type == "cuda":
            words = words.pin_memory().to(i.device, non_blocking=True)
        key = (words[:, :1], words[:, 1:])
    y0, y1 = _threefry2x32(key, i >> 32, i & _M32)
    return y0 ^ y1


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _lead(key) -> tuple:
    """The leading axis of a draw: none for a key, (K,) for K keys."""
    return () if _is_key(key) else (len(key),)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Words → float32 in [0, 1): 23 high bits as the mantissa of [1, 2),
    minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape, *, device="cuda") -> torch.Tensor:
    """U[0, 1) float32 of the requested shape (``jax.random.uniform``); a
    list of keys adds a leading axis, here and in every draw below."""
    shape = _shape(shape)
    u = _bits_to_unit(random_bits(key, math.prod(shape), device=device))
    return torch.clamp_min(u, 0.0).reshape(_lead(key) + shape)


# XLA's float32 erfinv (Giles, "Approximating the erfinv function"): the
# coefficients of the w < 5 and w >= 5 branches, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv as XLA expands it: w = -log1p(-x^2); p(w) by Horner in
    float32, each step c + p*w contracted to a fused multiply-add (as XLA's
    CPU backend emits it); x * inf at |x| == 1."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

    def coef(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])), float(np.float32(_ERFINV_GE5[i])))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


_SQRT2 = float(np.float32(math.sqrt(2.0)))


def normal(key, shape, *, device="cuda") -> torch.Tensor:
    """Standard normal float32 of the requested shape, as
    ``jax.random.normal`` computes it (uniform on [nextafter(-1, 0), 1),
    then sqrt(2) * erfinv), within a few ulp."""
    shape = _shape(shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    f = _bits_to_unit(random_bits(key, math.prod(shape), device=device))
    # (hi - lo) rounds to 2.0 in float32, so f * 2 is exact and lo is added once
    u = torch.clamp_min(f * 2.0 + lo, lo)
    return (_erfinv32(u) * _SQRT2).reshape(_lead(key) + shape)


_INV_SQRT3 = 0.5773502691896258


def unit_vector(key, shape=(), *, mode: str = "reference", device="cuda") -> torch.Tensor:
    """Random directions of shape ``shape + (3,)``.

    ``mode="reference"``: normalize(U[0,1)^3), the reference's
    positive-octant biased distribution; an exactly-zero sample (the
    reference retries, probability ~2^-96) gives the normalised one-vector.
    ``mode="sphere"``: uniform on the unit sphere (a normalised Gaussian).
    """
    shape = _shape(shape) + (3,)
    if mode == "reference":
        p = uniform(key, shape, device=device)
        n = _norm3(p)[..., None]
        return torch.where(n > 0.0, p / torch.clamp_min(n, 1e-30), _INV_SQRT3)
    if mode == "sphere":
        p = normal(key, shape, device=device)
        return p / torch.clamp_min(_norm3(p)[..., None], 1e-12)
    raise ValueError(f"unknown unit_vector mode {mode!r}")
