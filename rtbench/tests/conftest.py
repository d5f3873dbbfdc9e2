"""The benchmark's CPU tests: ``python -m pytest rtbench/tests`` from the
repository root.  The program's kernels run as their plain PyTorch
versions; a test that needs the card carries the ``cuda`` marker and skips
without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
