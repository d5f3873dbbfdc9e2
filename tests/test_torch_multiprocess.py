"""rt_tpu_torch.dist across processes on the CPU (the port of the JAX
package's tests/test_multiprocess.py, which is marked slow): ``python -m
rt_tpu_torch.mp_check --procs 2 --device cpu`` (two ranks that join a Gloo
world by TCP on a free port: the sharded frame bit for bit and the
gradients through it against a single process) and the sharded-render
example run by its path on 2 ranks.  Each command is a subprocess bounded
by 120 s, and its ranks run one torch thread."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(args, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


def test_mp_check_two_processes(tmp_path):
    proc = _run(["-m", "rt_tpu_torch.mp_check", "--procs", "2", "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "mp_check OK" in proc.stdout
    for rank in (0, 1):
        assert f"[rank {rank}] render parity ok" in proc.stdout
        assert f"[rank {rank}] summed gradients ok" in proc.stdout


def test_sharded_render_example(tmp_path):
    out = tmp_path / "sharded.png"
    proc = _run([str(REPO / "rt_tpu_torch" / "examples" / "sharded_render.py"), "--virtual", "2",
                 "--size", "64x48", "--spp", "2", "--out", str(out)], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "sharded == single-device: True" in proc.stdout
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
