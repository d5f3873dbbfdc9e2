"""A checkout-shaped directory holding BENCHMARK.json's cells at a size a
CPU test can run: each configuration's scene cut to a few spheres (or past
a router's threshold, where a test needs that route), a small frame, two
samples, depth 4."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, spheres: dict = None, size=(32, 24), spp=2, depth=4) -> Path:
    """A copy of the benchmark under ``tmp`` with every configuration cut;
    ``spheres`` maps a configuration's name to its cut sphere count (24 by
    default)."""
    spheres = spheres or {}
    (tmp / "rtbench").mkdir(parents=True, exist_ok=True)
    for d in ("traffic", "metrics", "limits", "configs"):
        shutil.copytree(ROOT / "rtbench" / d, tmp / "rtbench" / d, dirs_exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["scene"]["spheres"] = spheres.get(c["name"], 24)
        cfg["resolution"] = list(size)
        cfg["samples_per_pixel"] = spp
        cfg["max_bounces"] = depth
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
