"""Inverse rendering demo: recover a sphere's albedo from a rendered target
image (port of ``examples/inverse_rendering.py``), through the jnp-style
integrator (:func:`rt_tpu_torch.diff.render_for_loss`) and
:func:`rt_tpu_torch.train.fit`.

Usage::

    python -m rt_tpu_torch.examples.inverse_rendering [--steps 150]
        [--device cuda] [--out DIR]

Writes ``target.png``, ``before.png`` and ``after.png`` under ``--out``,
by default ``inverse_demo_torch`` in the temporary directory (``$TMPDIR``,
else ``/tmp``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

__all__ = ["main", "SCENE"]

SCENE = """
    materials = [
        { type = 'lambert', albedo = [0.85, 0.85, 0.85] },
        { type = 'lambert', albedo = [0.2, 0.45, 0.85] },
        { type = 'metal',   albedo = [0.9, 0.9, 0.9], roughness = 0.1 },
    ]
    spheres = [
        { material = 0, position = [0, -1000, 0], radius = 1000 },
        { material = 1, position = [-0.7, 0.5, 0] },
        { material = 2, position = [0.7, 0.5, 0] },
    ]
    camera = { position = [0, 1, 3], direction = 'forward' }
"""


def main(argv=None) -> dict:
    """Run the demo; returns ``{"losses": [...], "albedo1": [r, g, b]}``."""
    ap = argparse.ArgumentParser(prog="python -m rt_tpu_torch.examples.inverse_rendering")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the host)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "inverse_demo_torch"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import rt_tpu_torch
    from rt_tpu_torch import diff, train

    scene = rt_tpu_torch.loads(SCENE)
    size = (96, 64)
    key = rt_tpu_torch.rng.make_key(0)
    opts = dict(spp=4, max_bounces=4, device=args.device)

    true_params = diff.extract_params(scene)
    target = diff.render_for_loss(true_params, scene, size, key, **opts)

    # corrupt the blue sphere's albedo and optimize it back
    start = dict(true_params)
    albedo = true_params["materials.albedo"].clone()
    albedo[1] = torch.tensor([0.8, 0.8, 0.2, 1.0])
    start["materials.albedo"] = albedo
    start_scene = diff.apply_params(scene, start)

    def write(name, img):
        rt_tpu_torch.image.write_png(os.path.join(args.out, name),
                                     np.sqrt(np.maximum(img.detach().cpu().numpy(), 0)))

    os.makedirs(args.out, exist_ok=True)
    write("target.png", target)
    write("before.png", diff.render_for_loss(start, scene, size, key, **opts))

    params, losses = train.fit(start_scene, target, size, steps=args.steps, learning_rate=3e-2,
                               param_names=["materials.albedo"], log_every=25, **opts)
    albedo1 = params["materials.albedo"][1, :3].detach().cpu().numpy()
    print("recovered albedo[1]:", albedo1, " (true: [0.2, 0.45, 0.85])")

    write("after.png", diff.render_for_loss({**true_params, **params}, scene, size, key, **opts))
    print(f"wrote {args.out}/{{target,before,after}}.png")
    return {"losses": losses, "albedo1": albedo1.tolist()}


if __name__ == "__main__":
    main()
