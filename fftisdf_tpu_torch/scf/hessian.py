"""Vibrational analysis: FD-of-analytic-forces Hessian and normal modes.

Counterpart of ``fftisdf_tpu/scf/hessian.py``.  The nuclear Hessian is
assembled by central finite differences of the analytic reverse-mode
gradient (``scf.grad``), with the SCF re-converged at every displaced
geometry.  One gradient closure serves all 6 natm displacements.

``frequencies`` mass-weights the Hessian, projects out rigid translations
and returns harmonic wavenumbers in cm^-1 (negative values encode
imaginary modes).
"""
import numpy as np
import torch

from fftisdf_tpu_torch.basis.data import ATOMIC_MASS, element_symbol
from fftisdf_tpu_torch.isdf import jk as jk_mod
from fftisdf_tpu_torch.scf import grad as scf_grad
from fftisdf_tpu_torch.scf.optimize import _clone_mf
from fftisdf_tpu_torch.utils.device import as_tensor

AMU_TO_ME = 1822.888486209        # electron masses per amu
HARTREE_TO_CM1 = 219474.6313632   # E_h to cm^-1


class _FrozenPointDF:
    """J/K provider from a frozen-interpolation-point ISDF state re-fitted
    at a displaced geometry (the (x_k, wq) tensors of
    ``isdf.autodiff.isdf_state_fn``, not a full build), served through
    ``isdf.jk`` with ``FFTISDF.get_jk``'s calling convention; it also
    carries what the device-resident loop reads (``x_k``, ``wq``,
    :meth:`get_ws`).  ``s1e`` and ``mad`` (the displaced overlap and the
    Madelung constant) serve ``exxdiv='ewald'``."""

    trunc = None

    def __init__(self, x_k, wq, kmesh, s1e=None, mad=None):
        self.x_k, self.wq = x_k, wq
        self.device = wq.device
        self.kmesh = np.asarray(kmesh)
        self.s1e = (None if s1e is None
                    else as_tensor(s1e, self.device, wq.dtype))
        self.mad = mad
        self._ws = None

    def get_ws(self):
        if self._ws is None:
            self._ws = jk_mod.wq_to_ws(self.wq, self.kmesh)
        return self._ws

    def get_jk(self, dm_kpts, with_j=True, with_k=True, exxdiv=None,
               omega=None, kpts_band=None):
        if exxdiv not in (None, "ewald") or omega is not None \
                or kpts_band is not None:
            raise NotImplementedError(
                "_FrozenPointDF supports exxdiv in (None, 'ewald') J/K only")
        if exxdiv == "ewald" and (self.s1e is None or self.mad is None):
            raise NotImplementedError(
                "construct _FrozenPointDF with (s1e, mad) for "
                "exxdiv='ewald' serving")
        dm = as_tensor(dm_kpts, self.device, self.wq.dtype)
        single = dm.ndim == 3
        if single:
            dm = dm[None]
        vj = jk_mod.get_j_kpts(self.x_k, self.wq[0], dm) if with_j else None
        vk = None
        if with_k:
            vk = jk_mod.get_k_kpts_img(self.x_k, self.get_ws(), dm,
                                       self.kmesh)
            if exxdiv == "ewald":
                vk = jk_mod.add_ewald_exx(vk, self.s1e, dm, self.mad)
        if single:
            vj = None if vj is None else vj[0]
            vk = None if vk is None else vk[0]
        return vj, vk


def kernel(mf, step=1e-3, two_electron="pw", df=None, symmetrize=True,
           rows=None):
    """Nuclear Hessian d2E/dR2 (3 natm, 3 natm), Ha/bohr^2, and the
    analytic gradient at the reference geometry: ``(hess, g0)``.

    ``mf`` must be converged.  Each displaced SCF warm-starts from
    ``mf.dm``.  With ``two_electron='isdf'`` the interpolation points of
    ``df`` stay frozen and the displaced SCFs serve J/K from the
    frozen-point approximant re-fitted at the displaced positions
    (:class:`_FrozenPointDF`), so each density is stationary for exactly
    the functional being differentiated.

    ``rows`` restricts the displaced coordinates to those flat indices; the
    result is then (len(rows), 3 natm) (the supercell force-constant entry
    point of ``scf.phonon``; ``symmetrize`` is ignored)."""
    assert getattr(mf, "dm", None) is not None and mf.converged
    if getattr(mf, "trunc", None) is not None:
        raise NotImplementedError(
            "Hessians with a truncated Coulomb kernel (the displaced "
            "gradients trace the bare-kernel functional)")
    cell = mf.cell
    x0 = np.asarray(cell.atom_coords(), dtype=np.float64)
    n = 3 * len(x0)
    mf_exxdiv = getattr(mf, "exxdiv", None)
    device = df.device if df is not None else mf.device
    grad_fn = scf_grad.make_grad_fn(cell, mf.kpts, two_electron=two_electron,
                                    df=df, exxdiv=mf_exxdiv,
                                    xc=getattr(mf, "xc", None),
                                    hubbard=getattr(mf, "hubbard", None),
                                    device=device)
    if two_electron == "isdf":
        from fftisdf_tpu_torch.isdf.autodiff import isdf_state_fn
        from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
        from fftisdf_tpu_torch.scf.integrals import madelung

        state = isdf_state_fn(cell, mf.kpts, df.mask, m0=df.m0,
                              solver=df.solver, rcond=df.rcond,
                              dtype=df.rdtype, device=device)
        kmesh = kpt_mod.kpts_to_kmesh(cell, mf.kpts)
        mad = float(madelung(cell, kmesh)) if mf_exxdiv == "ewald" else None

    def grad_at(positions):
        new_cell = cell.copy(
            atom=[(sym, np.asarray(p)) for sym, p in
                  zip(cell.atom_symbols(), positions)]).build()
        frozen = None
        if two_electron == "isdf":
            with torch.no_grad():
                x_k, wq = state(torch.as_tensor(positions, dtype=df.rdtype,
                                                device=device))
            frozen = _FrozenPointDF(x_k, wq, kmesh, mad=mad)
        new_mf = _clone_mf(mf, new_cell, with_df=frozen)
        if frozen is not None:
            # the displaced geometry's overlap: what ewald exchange contracts
            frozen.s1e = as_tensor(new_mf.s1e, device, frozen.wq.dtype)
        new_mf.kernel(dm0=mf.dm)
        if not new_mf.converged:
            raise RuntimeError("SCF did not converge at a displaced "
                               "geometry; reduce `step` or loosen conv_tol")
        g, _ = grad_fn(new_mf)
        return np.asarray(g, dtype=np.float64).ravel()

    g0, _ = grad_fn(mf)
    idx = list(range(n)) if rows is None else [int(i) for i in rows]
    hess = np.empty((len(idx), n))
    for r, i in enumerate(idx):
        dx = np.zeros(n)
        dx[i] = step
        gp = grad_at((x0.ravel() + dx).reshape(-1, 3))
        gm = grad_at((x0.ravel() - dx).reshape(-1, 3))
        hess[r] = (gp - gm) / (2.0 * step)
    if symmetrize and rows is None:
        hess = 0.5 * (hess + hess.T)
    return hess, np.asarray(g0)


def frequencies(cell, hess, project_translations=True):
    """Harmonic wavenumbers (cm^-1, ascending; negative = imaginary) and
    mass-weighted normal modes from a (3 natm, 3 natm) Hessian."""
    masses = np.array([ATOMIC_MASS[element_symbol(s)] * AMU_TO_ME
                       for s in cell.atom_symbols()])
    minv = 1.0 / np.sqrt(np.repeat(masses, 3))
    hw = hess * minv[:, None] * minv[None, :]
    if project_translations:
        n = hw.shape[0]
        basis = np.zeros((n, 3))
        sq = np.sqrt(np.repeat(masses, 3))
        for a in range(3):
            basis[a::3, a] = sq[a::3]
        q, _ = np.linalg.qr(basis)
        proj = np.eye(n) - q @ q.T
        hw = proj @ hw @ proj
    ev, modes = np.linalg.eigh(hw)
    wav = np.sign(ev) * np.sqrt(np.abs(ev)) * HARTREE_TO_CM1
    return wav, modes
