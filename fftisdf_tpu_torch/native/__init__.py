"""ctypes bindings for the native host-side lattice engine.

The port's copy of the JAX package's ``fftisdf_tpu/native`` loader, for the
two entry points the port calls (image enumeration and the real-space
Ewald sum).  Builds ``csrc/lattice_engine.cpp`` on demand with g++ into
``_build/``; every entry point returns None without the library, and its
caller takes a pure-Python path, so the port works without a toolchain.
Set ``FFTISDF_TPU_NO_NATIVE=1`` to force the Python paths (the same switch
as the JAX package's).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "lattice_engine.cpp"
LIB_PATH = _HERE / "_build" / "liblattice_engine.so"

_LIB = None
_TRIED = False


def load():
    """Return the loaded library or None (after one build attempt)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FFTISDF_TPU_NO_NATIVE"):
        return None
    try:
        if (not LIB_PATH.exists()
                or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime):
            _build()
        _LIB = ctypes.CDLL(str(LIB_PATH))
        _declare(_LIB)
    except Exception as exc:  # toolchain missing, build failure, ...
        print(f"fftisdf_tpu_torch.native: falling back to Python ({exc})",
              file=sys.stderr)
        _LIB = None
    return _LIB


def _build():
    # into a temporary name, then an atomic rename: processes that build at
    # once (test workers) each leave one complete library
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-o",
                        tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib):
    d = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.enumerate_images.restype = ctypes.c_int64
    lib.enumerate_images.argtypes = [d, d, d, ctypes.c_double, i64, d,
                                     ctypes.c_int64]
    lib.ewald_real.restype = ctypes.c_double
    lib.ewald_real.argtypes = [d, d, ctypes.c_int64, d, ctypes.c_int64,
                               ctypes.c_double]


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def enumerate_images(a, center, cell_center, reach, nmax):
    """Native image enumeration; returns (n, 3) float64 or None if no lib."""
    lib = load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.float64)
    center = np.ascontiguousarray(center, dtype=np.float64)
    cc = np.ascontiguousarray(cell_center, dtype=np.float64)
    nmax = np.ascontiguousarray(nmax, dtype=np.int64)
    cap = int(np.prod(2 * nmax + 1))
    out = np.empty((cap, 3), dtype=np.float64)
    n = lib.enumerate_images(_dptr(a), _dptr(center), _dptr(cc),
                             ctypes.c_double(float(reach)), _iptr(nmax),
                             _dptr(out), ctypes.c_int64(cap))
    return out[:n].copy()


def ewald_real(coords, charges, ts, eta):
    """Native real-space Ewald sum or None."""
    lib = load()
    if lib is None:
        return None
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    charges = np.ascontiguousarray(charges, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    return float(lib.ewald_real(_dptr(coords), _dptr(charges),
                                ctypes.c_int64(len(charges)), _dptr(ts),
                                ctypes.c_int64(len(ts)),
                                ctypes.c_double(float(eta))))
