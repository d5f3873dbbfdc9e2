"""Material scattering on torch tensors (port of ``rt_tpu.materials``).

Renderer personalities map the 8 material types onto 3 BRDF classes:

* ``mg`` (mg_ray_tracer.cpp:142-152): metal → metal, everything else →
  lambert (dielectrics included!).
* ``sm`` (sm_ray_tracer.cpp:221-236): metal → metal; dielectric, air,
  vacuum, water, ice → dielectric; lambert & diamond → lambert.

:func:`scatter` is the branchless scatter of the JAX package: every BRDF is
evaluated for every ray and the result is selected by class.  It is
differentiable with respect to the material parameters and the geometry;
the class, coin and degeneracy decisions are detached, and ``decisions``
pins them to recorded values (the replay, :mod:`rt_tpu_torch.replay`).
The kernels carry their own scatter (``csrc/trace.cuh``).

BRDF semantics (bit-for-bit formula parity with the reference):

* lambert (mg_ray_tracer.cpp:109-123): scatter = normalize(normal +
  random_unit_vector()), degenerate → normal; attenuation = albedo.rgb *
  reflectivity.
* metal (mg_ray_tracer.cpp:125-140): scatter = reflect(normalize(dir),
  normal) + roughness * random_unit_vector(); absorbed if scatter·normal
  <= 0; attenuation = albedo.rgb * reflectivity.
* dielectric (sm_ray_tracer.cpp:181-219): the material's ``reflectivity``
  doubles as the IOR; a Schlick-probability coin picks reflect or refract;
  attenuation = albedo.rgb * reflectivity.  The reference reflects about
  the geometric normal and computes the inside cosine as ior * dot(d, n);
  both are reproduced.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ScatterResult", "scatter", "LAMBERT", "METAL", "DIELECTRIC", "personality_classes"]

LAMBERT, METAL, DIELECTRIC = 0, 1, 2

# material_type enum order: lambert, metal, dielectric, air, vacuum, water,
# ice, diamond (common.hpp:105-115).
_MG_CLASSES = (LAMBERT, METAL, LAMBERT, LAMBERT, LAMBERT, LAMBERT, LAMBERT, LAMBERT)
_SM_CLASSES = (LAMBERT, METAL, DIELECTRIC, DIELECTRIC, DIELECTRIC, DIELECTRIC, DIELECTRIC, LAMBERT)


def personality_classes(personality: str) -> torch.Tensor:
    """Material-type → BRDF-class lookup table (int32, on the CPU)."""
    if personality == "mg":
        return torch.tensor(_MG_CLASSES, dtype=torch.int32)
    if personality == "sm":
        return torch.tensor(_SM_CLASSES, dtype=torch.int32)
    raise ValueError(f"unknown personality {personality!r}")


# imported here, as in the JAX package: rt_tpu_torch.ops imports
# personality_classes from this module
from .ops.intersect import dot3, gather_rows, safe_normalize  # noqa: E402


class ScatterResult(NamedTuple):
    direction: torch.Tensor    # (N, 3) unit scatter direction
    attenuation: torch.Tensor  # (N, 3)
    absorbed: torch.Tensor     # (N,) bool: the ray dies with zero contribution
    # the discrete decisions, recorded for the replay
    reflect_bit: torch.Tensor  # (N,) bool: the dielectric took the reflect branch
    lam_deg: torch.Tensor      # (N,) bool: lambert degenerate (normal + ruv ~ 0)


def _reflect(v, n):
    """reflect() (common.hpp:100-103): v - 2 (v·n) n."""
    return v - 2.0 * dot3(v, n)[:, None] * n


def scatter(materials, brdf_class, mat_idx, ray_dir, normal, unit_rand, coin,
            decisions=None) -> ScatterResult:
    """Evaluate every BRDF and select by class.

    Args:
      materials: a :class:`rt_tpu_torch.scene.Materials`.
      brdf_class: (N,) integer BRDF class per ray.
      mat_idx: (N,) integer material index per ray.
      ray_dir: (N, 3) unit incoming direction; normal: (N, 3) geometric
        normal at the hit.
      unit_rand: (N, 3) random_unit_vector() samples; coin: (N,) U[0,1) for
        the dielectric reflect/refract coin.
      decisions: optional ``(reflect_bit, lam_deg)`` (N,) bool overrides.

    The JAX package fetches each material with a one-hot matmul at
    precision "highest", which returns the table's values exactly; here an
    index gather returns the same values, and autograd adds the gradient
    back into the gathered rows (in float64).  The expressions round as
    the kernels' scatter does (:mod:`rt_tpu_torch.ops.intersect`).
    """
    albedo = gather_rows(materials.albedo, mat_idx)[:, :3]          # (N, 3)
    roughness = gather_rows(materials.roughness, mat_idx)[:, None]  # (N, 1)
    refl = gather_rows(materials.reflectivity, mat_idx)             # (N,)

    # shared attenuation: albedo * reflectivity (mg_ray_tracer.cpp:115,131;
    # sm_ray_tracer.cpp:194)
    attenuation = albedo * refl[:, None]

    # lambert
    lam_raw = normal + unit_rand
    lam_deg = dot3(lam_raw, lam_raw) < 1e-16 if decisions is None else decisions[1]
    lam = torch.where(lam_deg[:, None], normal, safe_normalize(lam_raw))

    # metal
    met = _reflect(ray_dir, normal) + roughness * unit_rand
    metal_absorbed = dot3(met, normal) <= 0.0
    met = safe_normalize(met)

    # dielectric
    dn = dot3(ray_dir, normal)
    inside = dn > 0.0
    outward_n = torch.where(inside[:, None], -normal, normal)
    eta = torch.where(inside, refl, 1.0 / torch.clamp_min(refl, 1e-12))
    cosine = torch.where(inside, refl * dn, -dn)  # |dir| == 1
    cos_i = -dot3(ray_dir, outward_n)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    # guarded square root (finite gradient at the TIR boundary)
    cos_t = torch.sqrt(torch.where(tir, 1.0, torch.clamp_min(1.0 - sin2_t, 1e-12)))
    cos_t = torch.where(tir, 0.0, cos_t)
    refracted = eta[:, None] * ray_dir + (eta * cos_i - cos_t)[:, None] * outward_n
    # Schlick with the material's IOR on either side (sm:211); x**5 as XLA's
    # integer power evaluates it, (x*x)*(x*x)*x
    r0 = (1.0 - refl) / (1.0 + refl)
    r0 = r0 * r0
    omc = 1.0 - cosine
    omc2 = omc * omc
    reflect_prob = torch.where(tir, 1.0, r0 + (1.0 - r0) * (omc2 * omc2 * omc))
    reflect_bit = coin < reflect_prob if decisions is None else decisions[0]
    # the reference reflects about the geometric normal (sm:188)
    die = torch.where(reflect_bit[:, None], _reflect(ray_dir, normal), refracted)
    die = safe_normalize(die, fallback=normal)

    is_metal = brdf_class == METAL
    is_diel = brdf_class == DIELECTRIC
    direction = torch.where(is_metal[:, None], met, lam)
    direction = torch.where(is_diel[:, None], die, direction)
    absorbed = is_metal & metal_absorbed
    return ScatterResult(direction=direction, attenuation=attenuation, absorbed=absorbed,
                         reflect_bit=reflect_bit, lam_deg=lam_deg)
