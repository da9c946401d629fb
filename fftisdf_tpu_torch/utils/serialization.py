"""The ISDF build state and SCF checkpoints on disk, in the JAX package's
``.npz`` formats.

Counterpart of ``fftisdf_tpu/utils/serialization.py``.  The ISDF state is
one ``.npz`` with ``x_k``, ``wq``, ``mask``, ``kpts``, ``kmesh``, ``mesh``,
``c0``, ``m0`` (the densified mesh that ``mask`` indexes), ``solver`` and
the truncation spec.  A state written by either package, in complex128 or
complex64, with or without a truncated kernel, loads in the other.  An
SCF checkpoint (:func:`save_scf`) holds the density, the orbitals and the
energies under the JAX package's keys, so either package restarts from the
other's.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.utils.device import to_numpy


def save_isdf_state(path, df):
    """Write ``df``'s state.  A mesh-sharded state is gathered first (a
    collective: every rank calls this) and rank 0 writes it."""
    mesh = getattr(df, "dev_mesh", None)
    wq = df.wq if mesh is None else df.wq.full()
    if mesh is not None and mesh.rank != 0:
        return
    np.savez_compressed(
        path,
        x_k=to_numpy(df.x_k),
        wq=to_numpy(wq),
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


# ----------------------------------------------------------------------
# SCF checkpoint: the state of a scf.hf driver, key for key the JAX
# package's ``save_scf`` format.

def save_scf(path, mf):
    """Checkpoint a (converged or mid-run) SCF driver to one ``.npz``: the
    density matrix (the restart payload), the orbital energies,
    coefficients and occupations when they are regular arrays (canonical
    orthogonalisation can make them ragged across k; then only the density
    is stored), and the scalar results.  Restart:
    ``mf.kernel(dm0=load_scf(path)["dm"])``."""
    if getattr(mf, "dm", None) is None:
        raise ValueError("nothing to save: run mf.kernel() first")
    payload = {
        "driver": type(mf).__name__,
        "xc": str(getattr(mf, "xc", "")),
        "kpts": np.asarray(mf.kpts),
        "mesh": np.asarray(mf.cell.mesh),
        "dm": np.asarray(to_numpy(mf.dm)),
        "e_tot": float(mf.e_tot),
        "e_free": float(mf.e_free if mf.e_free is not None else mf.e_tot),
        "entropy": float(getattr(mf, "entropy", 0.0)),
        "converged": bool(mf.converged),
        "smearing": float(getattr(mf, "smearing", 0.0)),
    }
    mu = getattr(mf, "mu", None)
    if mu is not None:
        payload["mu"] = np.atleast_1d(np.asarray(mu, dtype=float))
    for name in ("mo_energy", "mo_coeff", "mo_occ"):
        arr = getattr(mf, name, None)
        if arr is None:
            continue
        try:
            arr = np.asarray(arr)
        except ValueError:                # ragged across k
            continue
        if arr.dtype != object:
            payload[name] = arr
    np.savez_compressed(path, **payload)
    return path


def load_scf(path, cell=None, kpts=None):
    """An SCF checkpoint as a dict.  When ``cell``/``kpts`` are given the
    stored FFT mesh and k-points must match them (a density of another
    geometry would restart silently wrong)."""
    with np.load(path, allow_pickle=False) as data:
        if kpts is not None and not np.allclose(
                data["kpts"], np.asarray(kpts), atol=1e-10):
            raise ValueError("stored k-points do not match")
        if cell is not None and not np.array_equal(
                data["mesh"], np.asarray(cell.mesh)):
            raise ValueError("stored FFT mesh does not match cell")
        out = {k: data[k] for k in data.files}
    for k in ("e_tot", "e_free", "entropy", "smearing"):
        out[k] = float(out[k])
    out["converged"] = bool(out["converged"])
    out["driver"] = str(out["driver"])
    out["xc"] = str(out["xc"])
    return out
