"""JAX-free access to the numpy layer the port shares with ``fftisdf_tpu``.

The port reuses the JAX package's host-side modules as they are: the cell
and k-point code (``fftisdf_tpu.lattice``), the basis tables and GTO
conventions (``fftisdf_tpu.basis.data``, ``fftisdf_tpu.basis.gto``), the
ctypes lattice engine (``fftisdf_tpu.native``) and the logger.  None of them
imports JAX, but ``fftisdf_tpu/basis/__init__.py`` does (it re-exports the
jitted evaluator), and ``Cell.build`` imports ``fftisdf_tpu.basis.data``.

Where JAX is not installed (the GPU machine), importing this module
registers a bare ``fftisdf_tpu.basis`` package whose ``__path__`` is the
real directory, so ``basis.data`` and ``basis.gto`` load without running
the package init.  Where JAX is installed nothing is changed: the JAX
package's own modules, which may share the process (the parity tests), keep
their normal ``fftisdf_tpu.basis``.

The port never imports ``fftisdf_tpu.{linalg,scf,isdf,ops,utils.device}``.
"""
from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path


def _jax_importable() -> bool:
    try:
        return importlib.util.find_spec("jax") is not None
    except (ImportError, ValueError):
        return False


def _register_bare_basis_package():
    import fftisdf_tpu

    name = "fftisdf_tpu.basis"
    if name in sys.modules:
        return
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(Path(fftisdf_tpu.__file__).resolve().parent
                        / "basis")]
    pkg.__package__ = name
    sys.modules[name] = pkg
    fftisdf_tpu.basis = pkg


if not _jax_importable():
    _register_bare_basis_package()

from fftisdf_tpu import native  # noqa: E402,F401
from fftisdf_tpu.basis import data as basis_data  # noqa: E402,F401
from fftisdf_tpu.basis.gto import (  # noqa: E402,F401
    normalized_coeffs, real_solid_harmonics, shell_rcut)
from fftisdf_tpu.lattice import kpoints as kpt_mod  # noqa: E402,F401
from fftisdf_tpu.lattice import structure  # noqa: E402,F401
from fftisdf_tpu.lattice.cell import Cell, Shell  # noqa: E402,F401
from fftisdf_tpu.utils.logging import Logger  # noqa: E402,F401
