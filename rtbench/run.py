"""One run of one cell of the benchmark (see ``rtbench/README.md``)::

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for torch's CPU work: with a pool as wide as the machine,
# its idle workers contend with the thread that feeds the card, and the
# wavefront frame's host time swung by a third between processes
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

# run as a script: import the benchmark and the program from the checkout's
# root, never from this directory
_ROOT = str(Path(__file__).resolve().parent.parent)
sys.path[:] = [_ROOT] + [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]

from rtbench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
