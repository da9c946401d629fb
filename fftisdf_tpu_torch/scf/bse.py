"""Bethe-Salpeter equation (Tamm-Dancoff) optical excitations on the
ISDF state: the GW+BSE method for absorption spectra and exciton binding
in solids (Rohlfing & Louie, PRB 62, 4927 (2000)).

Counterpart of ``fftisdf_tpu/scf/bse.py``.  Every electron-hole coupling
collapses onto the nip x nip interpolation (fitting) space of the build
that served the SCF:

    A_{(k)ia,(k')jb} = (E^QP_{a,k+q} - E^QP_{i,k}) delta_{k k', ij, ab}
        + 2 (a k+q, i k | j k', b k'+q)/nk         [bare exchange; singlet]
        - W^0_{(a b),(j i)}/nk                     [statically screened
                                                    direct term]

The exchange term is the TDA Coulomb piece; the direct term is the TDA
exact-exchange piece with the bare metric w_q replaced by the statically
screened one

    W_q(0) = w_q + w_q chi0_q(0) (1 - w_q chi0_q(0))^{-1} w_q,

chi0_q(0) the omega = 0 slice of the RPA polarisability of ``scf.gw``; at
chi0 = 0 BSE is CIS.  chi0 is Hermitian here (A g A^H, ``scf.rpa``), so
W_q(0) and the BSE operator are; the JAX package's A g A^T makes them
Hermitian only for real orbitals.  ``qp_energy`` (e.g. from
``scf.gw.g0w0``) replaces the mean-field eigenvalues in the diagonal.
BSE eigenvectors share the TDA flat layout, so
``scf.tddft.oscillator_strengths`` applies unchanged.
Tensors stay on the device of the ISDF state.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.scf import gw as gw_mod
from fftisdf_tpu_torch.scf.rpa import _chi, _sector_pairs
from fftisdf_tpu_torch.scf.tddft import (_apply_blocks, _coul_piece,
                                         _dense, _exch_piece, _ka_map,
                                         _mo_setup, _project, _solve)
from fftisdf_tpu_torch.utils.device import real_complex


def _static_w_q(pair_amp, delta, wq, inv_nk):
    """Statically screened sector metric W_q(0) = w + m (I - m)^{-1} w,
    m = w chi0_q(0), chi0 built exactly as scf.gw does at omega = 0."""
    om0 = torch.zeros(1, dtype=delta.dtype, device=delta.device)
    m = wq @ (inv_nk * _chi(pair_amp, delta, om0)[0])
    eye = torch.eye(wq.shape[0], dtype=wq.dtype, device=wq.device)
    return wq + m @ torch.linalg.solve(eye - m, wq)


def static_w(df, mf, qp_energy=None):
    """The (nk, nip, nip) statically screened Coulomb metric W_q(0).

    chi0 uses the mean-field occ/virt energies by default (GW+BSE practice
    screens with the RPA of the mean-field system); ``qp_energy`` switches
    the polarisability poles to QP energies (eigenvalue-self-consistent
    screening)."""
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy if qp_energy is None else qp_energy)
    mo_o = np.asarray(mf.mo_occ)
    assert mo_c.ndim == 3, "restricted (KRHF/KRKS) reference required"
    nocc = int(round(mo_o[0].sum() / 2))
    _, xo, xv = gw_mod._mo_blocks(df, mo_c, nocc)
    out = torch.empty_like(df.wq)
    for q in range(nk):
        pair_amp, delta = _sector_pairs(df, xo, xv, mo_e, nocc, q)
        out[q] = _static_w_q(pair_amp, delta, df.wq[q], 1.0 / nk)
    return out


class BSEOperator:
    """Matrix-free BSE-TDA operator at momentum-transfer index q.

    ``mf``: converged restricted reference (KRHF/KRKS, insulating);
    ``df``: the built FFTISDF; ``qp_energy``: optional (nk, nmo) QP
    eigenvalues for the diagonal (``scf.gw.g0w0`` output); ``wqs``: a
    precomputed static W tensor (built here by :func:`static_w` when
    absent); ``singlet=False`` drops the bare exchange term (triplet
    excitons: only the screened direct term binds them)."""

    def __init__(self, mf, df, q=0, singlet=True, qp_energy=None,
                 wqs=None):
        kpts = np.asarray(mf.kpts)
        nk = len(kpts)
        self.nk, self.q, self.singlet = nk, int(q), bool(singlet)
        mo_c, mo_e, nocc = _mo_setup(mf)
        if qp_energy is not None:
            mo_e = np.asarray(qp_energy)
            assert mo_e.shape == (nk, mo_c.shape[-1]), \
                "qp_energy must be (nk, nmo)"
        nmo = mo_c.shape[-1]
        self.nocc, self.nvir = nocc, nmo - nocc
        k2c = df.kconserv2()
        self.ka_of = _ka_map(k2c, self.q)
        self.delta = np.stack([
            mo_e[self.ka_of[ki]][None, nocc:] - mo_e[ki][:nocc, None]
            for ki in range(nk)])                       # (nk, no, nv)
        self.device, cdt = df.x_k.device, df.cdtype
        self._cdt = cdt
        self.xo = _project(df.x_k, mo_c, range(nk), slice(0, nocc), cdt)
        self.xva = _project(df.x_k, mo_c, self.ka_of, slice(nocc, nmo), cdt)
        self.wq = df.wq
        self.wqs = static_w(df, mf) if wqs is None else wqs
        self.qc = int(k2c[self.ka_of[0], 0])
        self.qx = torch.as_tensor(k2c.astype(np.int64), device=self.device)
        self._delta_dev = torch.as_tensor(self.delta,
                                          dtype=real_complex(cdt)[0],
                                          device=self.device)
        self._per_vec = 3 * nk * df.nip ** 2 * df.x_k.element_size()
        self.shape = (nk, nocc, self.nvir)
        self.size = nk * nocc * self.nvir

    def apply(self, xd):
        """A applied to a device block (m, nk, no, nv)."""
        y = self._delta_dev * xd
        if self.singlet:
            y = y + _coul_piece(self.xo, self.xva, self.wq[self.qc], xd,
                                self.nk)
        # screened direct term: the TDA exchange piece through W_q(0)
        return y + _exch_piece(self.xo, self.xva, self.wqs, self.qx, xd,
                               self.nk)

    def matvec(self, x):
        """A @ x for host x: flat, shaped (nk, no, nv) or a block (size,
        m) of columns; returns the same layout."""
        return _apply_blocks(
            lambda xd: self.apply(xd.reshape(-1, *self.shape)).reshape(
                xd.shape[0], -1),
            x, self.size, self.shape, self._per_vec, self.device, self._cdt)

    def dense(self):
        return _dense(self)


def bse(mf, df, q=0, nroots=5, singlet=True, qp_energy=None, tol=1e-6,
        max_cycle=200, dense=None, wqs=None):
    """Lowest BSE-TDA excitations at momentum-transfer index q.

    Returns (omega (nroots,), info dict with the operator, eigenvectors,
    and the hermiticity diagnostic).  With ``scf.gw.g0w0`` the GW+BSE
    recipe is

        qp, _ = gw.g0w0(df, mf)               # (nk, nmo)
        w, info = bse(mf, df, qp_energy=qp)
    """
    op = BSEOperator(mf, df, q=q, singlet=singlet, qp_energy=qp_energy,
                     wqs=wqs)
    return _solve(op, nroots, tol, max_cycle, dense)
