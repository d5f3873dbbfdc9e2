"""Builds the CUDA sources of ``rt_tpu_torch/csrc`` with nvcc, at first use.

Each source becomes a shared library with a plain C entry point, loaded
with :mod:`ctypes` (no PyTorch headers: a build takes seconds).  Libraries
go to ``rt_tpu_torch/_build/`` under a name keyed on a hash of the sources
and the flags, so an edit rebuilds and an unchanged tree reuses the build.
A build writes a temporary file and renames it into place, so concurrent
processes never load a half-written library.  nvcc's report (registers,
spills, shared memory per kernel, from ``-Xptxas=-v``) is kept beside the
library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load_library"]

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

# --fmad=false: no a*b+c is contracted into an FMA, so the kernels round
# every operation once, as their plain PyTorch versions do (see the note in
# csrc/render_kernel.cu).  Never --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the CUDA kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Path of ``lib<name>-<hash>.so`` built from ``csrc/<name>.cu``."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{proc.stderr}")
    log_tmp = tmp.with_suffix(".log")
    log_tmp.write_text(proc.stdout + proc.stderr)
    os.replace(log_tmp, out.with_suffix(".log"))
    os.replace(tmp, out)
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(str(build(name)))
