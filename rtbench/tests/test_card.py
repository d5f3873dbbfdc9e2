"""On the card: one short run of every cell through the command
BENCHMARK.json names, in a fresh process each (``python -m pytest -m cuda
rtbench/tests/test_card.py`` on a machine with H100s; a cell is skipped
where the machine has fewer cards than it asks for)."""

import json
import subprocess
import sys

import pytest

from rtbench.tests.test_harness import BENCH, CELLS
from rtbench.tests.tiny import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    chips = next(w["chips"] for w in BENCH["workloads"] if w["name"] == cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    cmd = [sys.executable if a == "python3" else a for a in BENCH["command"]]
    proc = subprocess.run(cmd + ["--workload", cell, "--seed", "2147483650", "--seconds", "2",
                                 "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == chips
