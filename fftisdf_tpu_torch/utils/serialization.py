"""The ISDF build state on disk, in the JAX package's ``.npz`` format.

Counterpart of ``fftisdf_tpu/utils/serialization.py::{save,load}_isdf_state``:
one ``.npz`` with ``x_k``, ``wq``, ``mask``, ``kpts``, ``kmesh``, ``mesh``,
``c0``, ``m0`` (the densified mesh that ``mask`` indexes), ``solver`` and
the truncation spec.  A state written by either package, in complex128 or
complex64, with or without a truncated kernel, loads in the other.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.utils.device import to_numpy


def save_isdf_state(path, df):
    np.savez_compressed(
        path,
        x_k=to_numpy(df.x_k),
        wq=to_numpy(df.wq),
        mask=np.asarray(df.mask),
        kpts=np.asarray(df.kpts),
        kmesh=np.asarray(df.kmesh),
        mesh=np.asarray(df.cell.mesh),
        c0=df.c0,
        m0=np.asarray(df.m0),
        solver=df.solver,
        # the metric has the truncated kernel baked in, so a reload must
        # carry the spec ('' = none)
        trunc_kind="" if df.trunc is None else str(df.trunc[0]),
        trunc_rc=0.0 if df.trunc is None else float(df.trunc[1]),
    )


def load_isdf_state(path, cell, kpts, dtype=None, *, device="cuda"):
    """A built :class:`~fftisdf_tpu_torch.isdf.kpoint.FFTISDF` on ``device``
    serving from the state stored at ``path``, in ``dtype`` or, when None,
    in the stored arrays' precision (the JAX package widens a float32
    state to complex128 on disk; the port stores complex64).  The stored
    k-points and FFT mesh must match ``kpts`` and ``cell``."""
    from fftisdf_tpu_torch.isdf.kpoint import FFTISDF

    with np.load(path, allow_pickle=False) as data:
        if not np.allclose(data["kpts"], np.asarray(kpts), atol=1e-10):
            raise ValueError("stored k-points do not match")
        if not np.array_equal(data["mesh"], np.asarray(cell.mesh)):
            raise ValueError("stored FFT mesh does not match cell")
        trunc = None
        if "trunc_kind" in data.files and str(data["trunc_kind"]):
            trunc = (str(data["trunc_kind"]), float(data["trunc_rc"]))
        return FFTISDF.from_numpy(
            cell, kpts, data["x_k"], data["wq"], data["mask"],
            m0=tuple(int(v) for v in data["m0"]), c0=float(data["c0"]),
            solver=str(data["solver"]), trunc=trunc, dtype=dtype,
            device=device)
