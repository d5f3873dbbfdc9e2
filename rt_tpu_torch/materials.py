"""Material classes of the renderer personalities (port of
``rt_tpu.materials``, the class table only).

Renderer personalities map the 8 material types onto 3 BRDF classes:

* ``mg`` (mg_ray_tracer.cpp:142-152): metal → metal, everything else →
  lambert (dielectrics included!).
* ``sm`` (sm_ray_tracer.cpp:221-236): metal → metal; dielectric, air,
  vacuum, water, ice → dielectric; lambert & diamond → lambert.

The scatter functions themselves live in the render kernel
(:mod:`rt_tpu_torch.ops.render`); the branchless ``scatter`` of the jnp
integrator is ported together with that integrator.
"""

from __future__ import annotations

import torch

__all__ = ["LAMBERT", "METAL", "DIELECTRIC", "personality_classes"]

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
