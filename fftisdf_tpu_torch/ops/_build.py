"""Build-at-first-use of the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), under
``ops/_build/``, named by a hash of the source and the flags.  A library
that already exists for the same hash is reused.  The build targets Hopper
(``sm_90a``).  ``nvcc`` is looked up on ``PATH``, then under ``CUDA_HOME``
and ``/usr/local/cuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


class KernelLibrary:
    """One compiled ``csrc/<name>.cu``: ``load()`` builds it on first use
    and returns the ``ctypes.CDLL``; ``build_seconds`` and ``ptxas_log``
    record the last build (0.0 and '' when an existing library was
    reused)."""

    def __init__(self, name: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self._lib = None
        self.build_seconds = 0.0
        self.ptxas_log = ""

    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        lib_path = self.path()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {self.source.name}:\n"
                        f"{proc.stdout}\n{proc.stderr}")
                # an atomic rename: a concurrent build of the same hash
                # leaves one complete library
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self.build_seconds = time.perf_counter() - t0
            self.ptxas_log = proc.stderr
        self._lib = ctypes.CDLL(str(lib_path))
        return self._lib
