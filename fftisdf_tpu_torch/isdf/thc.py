"""LS-THC with k-points: interpolation factors fitted against Cholesky
ERIs.

Counterpart of ``fftisdf_tpu/isdf/thc.py`` (the reference's
``k_least_square.py``, SURVEY.md section 2a #15).  Instead of the FFT
Coulomb kernel, the fit targets the 3-index Cholesky factor of the ERIs,

    cderi_{k1 k2}[Q, mn] ~= sum_I coul_q[Q, I] conj(x_{k1,I,m}) x_{k2,I,n},

by least squares: coul_q = rhs_q pinv(zeta_q) with

    zeta_q = (X_{k1} X_{k1}^H) (.) (X_{k2} X_{k2}^H)^*            (ref :143-158)
    rhs_q[Q, I] = sum_{mn} cderi[Q, mn] x_{k1,I,m} conj(x_{k2,I,n})  (:178-198)

Interpolation points are pooled across q by accumulating the pivoted
Cholesky's pivot weights (ref :160-170).  The cderi oracle is the exact
plane-wave factor (:func:`pw_cderi`): with Z12(G) = FFT[conj(phi1) phi2
e^{-iq r}](G),

    cderi_{k1 k2}[G, mn] = sqrt(vol coulG(q)[G]) / N Z12(G)[mn],
    eri(12|34)_{mnkl} = sum_G cderi_{12}[G, mn] conj(cderi_{43}[G, lk]).

Everything runs on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.coulomb import get_coulG
from fftisdf_tpu_torch.linalg.fft import fft3
from fftisdf_tpu_torch.linalg.pivoted_cholesky import pivoted_cholesky
from fftisdf_tpu_torch.linalg.solvers import solve_fitting
from fftisdf_tpu_torch.pw.poisson import eiqr
from fftisdf_tpu_torch.utils.device import (as_tensor, real_complex,
                                            resolve_device)
from fftisdf_tpu_torch.utils.logging import Logger


def pw_cderi(cell, ao1, ao2, q, coords, mesh=None):
    """Exact plane-wave 3-index Cholesky factor (ngrid, nao, nao) of the
    pair (ao1, ao2), each (ngrid, nao) on the FFT grid of ``coords``.

    ``q`` must be the sector's canonical q-vector for both factors of an
    ERI contraction: the bra factor of the pair (k4, k3) is built with +q
    too, although that pair's momentum is -q modulo a reciprocal vector
    (the G offset would otherwise shift the FFT bins and break the
    pairing)."""
    mesh = cell.mesh if mesh is None else mesh
    ng, nao = ao1.shape
    rdt = real_complex(ao1.dtype)[0]
    rho = (ao1.conj()[:, :, None] * ao2[:, None, :]).reshape(ng, -1)
    ph = eiqr(as_tensor(coords, ao1.device, rdt), q).conj()
    z = fft3((rho * ph[:, None]).T, mesh)                 # (nao^2, ng)
    cg = get_coulG(cell, q=q, mesh=mesh, dtype=rdt, device=ao1.device)
    fac = torch.sqrt(cell.vol * cg) / ng
    return (z * fac[None, :]).T.reshape(ng, nao, nao)


class LSTHC:
    """Least-squares tensor hypercontraction over k-points.

    The reference's ``WithKPoints(LeastSquareFitting)``
    (``k_least_square.py:84-203``): the quadrature weights are folded into
    the AOs (sqrt(w), as its ``eval_gto`` does); ``grids`` None fits on
    the uniform FFT grid, else on ``grids.coords``/``grids.weights``
    (e.g. :class:`~fftisdf_tpu_torch.lattice.becke.AtomCenteredGrids`).
    :meth:`build`, then ``coul_q`` (nk, naux, nip) and ``xipt_k`` (nk,
    nip, nao) hold the THC factors, on ``device``."""

    def __init__(self, cell, kpts, verbose=3, grids=None, *, device="cuda"):
        self.device = resolve_device(device)
        self.cell = cell
        self.kpts = np.asarray(kpts)
        self.verbose = verbose
        self._log = Logger(verbose)
        self.grids = grids
        self.coul_q = None
        self.xipt_k = None
        self.mask = None

    def fit_coords_weights(self):
        if self.grids is not None:
            return (np.asarray(self.grids.coords),
                    np.asarray(self.grids.weights))
        coords = self.cell.gen_uniform_grids()
        ng = coords.shape[0]
        return coords, np.full(ng, self.cell.vol / ng)

    def eval_gto(self, coords, kpts, weights=None):
        """sqrt(weight)-scaled Bloch AOs (nk, ng, nao) (the reference
        folds sqrt(w) into the AOs, k_least_square.py:104-118)."""
        if weights is None:
            weights = np.full(coords.shape[0],
                              self.cell.vol / coords.shape[0])
        ao = make_evaluator(self.cell, kpts=kpts, device=self.device)(coords)
        sw = torch.as_tensor(np.sqrt(np.abs(weights)), dtype=torch.float64,
                             device=self.device)
        return ao * sw[None, :, None]

    def _fft_aos(self):
        coords = self.cell.gen_uniform_grids()
        return coords, make_evaluator(self.cell, kpts=self.kpts,
                                      device=self.device)(coords)

    def build(self, pivot_tol=1e-16, rcond=1e-12, row_only=False):
        """``row_only=True`` reproduces the reference: zeta and the RHS
        from the k1 = 0 row of pairs only (``k_least_square.py:146-158``),
        so pairs outside that row are represented only approximately.  By
        default every (k1, k2) pair of a sector is accumulated, which makes
        the fit exact at full rank."""
        cell, kpts, dev, log = self.cell, self.kpts, self.device, self._log
        nk = len(kpts)
        coords, weights = self.fit_coords_weights()
        phi_k = self.eval_gto(coords, kpts, weights)
        _, ng, nao = phi_k.shape
        k2c = kpt_mod.get_kconserv2(cell, kpts)
        # the cderi oracle lives on the FFT mesh whatever the fitting grid
        fft_coords, ao_fft = self._fft_aos()
        naux = fft_coords.shape[0]

        k1_range = [0] if row_only else range(nk)
        z_q = torch.zeros((nk, ng, ng), dtype=phi_k.dtype, device=dev)
        for k1 in k1_range:
            s1 = phi_k[k1].conj() @ phi_k[k1].T
            for k2 in range(nk):
                z_q[k2c[k1, k2]] += s1 * (phi_k[k2] @ phi_k[k2].mH)

        # pivot pooling across q (ref :160-170).  z_q sums one Hadamard
        # product of rank-nao grams per k1, so its rank is at most
        # len(k1_range) nao^2: the factorisation stops there instead of
        # walking all ng pivots
        ww = np.zeros(ng)
        max_rank = min(ng, len(k1_range) * nao * nao)
        for q in range(nk):
            _, piv, rank, hist = pivoted_cholesky(z_q[q], tol=pivot_tol,
                                                  max_rank=max_rank)
            piv = piv[:rank].cpu().numpy()
            ww[piv] += hist[:rank].cpu().numpy()
            log.info("LSTHC: q=%d pivot rank %d / %d", q, rank, ng)
        mm = np.where(ww > 1e-16)[0]
        nip = len(mm)
        log.info("LSTHC: pooled nip = %d", nip)
        self.mask = mm
        mm_t = torch.as_tensor(mm, device=dev)
        zeta_q = z_q[:, mm_t][:, :, mm_t]
        del z_q
        xipt_k = phi_k[:, mm_t, :]

        # RHS from the cderi oracle (ref :178-198)
        rhs = torch.zeros((nk, naux, nip), dtype=phi_k.dtype, device=dev)
        for k1 in k1_range:
            for k2 in range(nk):
                q = k2c[k1, k2]
                cderi = pw_cderi(cell, ao_fft[k1], ao_fft[k2], kpts[q],
                                 fft_coords, cell.mesh)
                # sum_mn cderi[Q,m,n] x1[I,m] conj(x2[I,n])
                t = (xipt_k[k1][:, :, None]
                     * xipt_k[k2].conj()[:, None, :]).reshape(nip, -1)
                rhs[q] += cderi.reshape(naux, -1) @ t.T

        # per-q pinv solve (ref :200-203)
        self.coul_q = torch.stack([
            solve_fitting(zeta_q[q], rhs[q].T, method="pinv",
                          rcond=rcond)[0].T for q in range(nk)])
        self.xipt_k = xipt_k
        return self

    def cderi_sol(self, k1, k2):
        """THC-reconstructed cderi (naux, nao, nao) of the pair (k1, k2)."""
        q = kpt_mod.get_kconserv2(self.cell, self.kpts)[k1, k2]
        x1, x2 = self.xipt_k[k1], self.xipt_k[k2]
        nip = x1.shape[0]
        t = (x1.conj()[:, :, None] * x2[:, None, :]).reshape(nip, -1)
        return (self.coul_q[q] @ t).reshape(-1, x1.shape[1], x2.shape[1])

    def error_report(self):
        """Per-(k1, k2) (k1, k2, max |error|, Frobenius error) of the
        reconstructed cderi against the exact one (ref :205-238)."""
        cell, kpts = self.cell, self.kpts
        coords, ao_fft = self._fft_aos()
        k2c = kpt_mod.get_kconserv2(cell, kpts)
        out = []
        for k1 in range(len(kpts)):
            for k2 in range(len(kpts)):
                # the canonical sector q-vector (see pw_cderi)
                ref = pw_cderi(cell, ao_fft[k1], ao_fft[k2],
                               kpts[k2c[k1, k2]], coords, cell.mesh)
                diff = ref - self.cderi_sol(k1, k2)
                err1 = float(diff.abs().max())
                err2 = float(torch.linalg.vector_norm(diff))
                self._log.info("k1 = %d, k2 = %d, Max: %6.4e, Mean: %6.4e",
                               k1, k2, err1, err2)
                out.append((k1, k2, err1, err2))
        return out
