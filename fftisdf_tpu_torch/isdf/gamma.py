"""Gamma-point / global ISDF: one q-independent set of fitting functions.

Counterpart of ``fftisdf_tpu/isdf/gamma.py`` (the reference's ``isdf.py``
capability: a full-grid fit with one fitting-function set shared by every
k-point pair).  From AO values on the grid, interpolation points are
selected on the full pair-density gram and

    zeta[mask, mask] @ xi = zeta[mask, :]        (ref isdf.py:40-52)

is solved.  The fitted ``xi`` (nip, ngrid) reconstructs every AO pair
density as rho_{k1,k2}(g) ~= sum_I xi_I(g) conj(x_{k1,I,m}) x_{k2,I,n}
(ref isdf.py:85-88), and ERIs follow from one Poisson solve per q
(ref isdf.py:91-104).  Tensors stay on the device of the AO values.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.linalg.pivoted_cholesky import pivoted_cholesky
from fftisdf_tpu_torch.linalg.solvers import solve_fitting
from fftisdf_tpu_torch.pw.poisson import pair_potential


def pair_gram(ao_kpts):
    """zeta[g, h] = |(1/nk) sum_k conj(X_k) X_k^T|^2 elementwise, real
    (ng, ng).  ``ao_kpts`` (nk, ng, nao); a (ng, nao) gamma array is
    promoted."""
    if ao_kpts.ndim == 2:
        ao_kpts = ao_kpts[None]
    nk = ao_kpts.shape[0]
    x2 = (ao_kpts.conj() @ ao_kpts.transpose(1, 2)).sum(dim=0) / nk
    return x2.abs().square()


def fit_gamma(ao_kpts, nip=None, tol=1e-20, rcond=1e-13, solver="lstsq"):
    """Global ISDF fit: (xi (nip, ng), mask (nip,) numpy, rank).

    ``nip=None`` keeps every pivot above ``tol`` (the reference's
    full-rank regime, isdf.py:45-46)."""
    if ao_kpts.ndim == 2:
        ao_kpts = ao_kpts[None]
    zeta = pair_gram(ao_kpts)
    ng = zeta.shape[0]
    max_rank = ng if nip is None else min(int(nip), ng)
    _, piv, rank, _ = pivoted_cholesky(zeta, tol=tol, max_rank=max_rank)
    rank = int(rank)
    n_keep = min(max_rank, rank)
    mask = piv[:n_keep].cpu().numpy()
    mj = torch.as_tensor(mask, device=zeta.device)
    xi, _ = solve_fitting(zeta[mj][:, mj], zeta[mj], method=solver,
                          rcond=rcond)
    return xi, mask, rank


def reconstruct_pair(xi, mask, ao1, ao2):
    """rho_sol[g, m, n] = sum_I xi[I, g] conj(ao1[mask][I, m])
    ao2[mask][I, n]."""
    mj = torch.as_tensor(np.asarray(mask), device=ao1.device)
    x1, x2 = ao1[mj], ao2[mj]
    nip, n1 = x1.shape
    t = (x1.conj()[:, :, None] * x2[:, None, :]).reshape(nip, -1)
    return (xi.T.to(t.dtype) @ t).reshape(xi.shape[1], n1, x2.shape[1])


def coul_q_from_xi(cell, xi, coords, q, mesh=None):
    """coul_q[I, J] = <xi_I | v_coul(q) | xi_J>, the q-sector Coulomb
    metric of the global fitting functions (ref isdf.py:93-104,
    fftdf-with-k.py:151-167)."""
    mesh = cell.mesh if mesh is None else mesh
    ng = xi.shape[1]
    v = pair_potential(xi, q, coords, cell, mesh) * (cell.vol / ng)
    return v @ xi.conj().T.to(v.dtype)
