"""The ridge fitting solver and its split form.

Counterpart of the ridge family of ``fftisdf_tpu/linalg/solvers.py``: the
ISDF fit solves ``A z = B`` with ``A = x4_q`` (nip x nip hermitian PSD) per
momentum sector, by a Jacobi-scaled Tikhonov-regularised Cholesky solve.
The metric-side w_q assembly uses the split form S = H^H H with
``H b = C^{-1} D b`` and the finish ``P (H^H M H) P^H``, where P is the
iterative-refinement polynomial (identity at the f64 default, refine=0).

The eigh-family methods (lstsq, pinv, svd) are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch


def _check_method(method):
    if method != "ridge":
        raise NotImplementedError(
            f"fitting solver {method!r}: only 'ridge' is ported")


def _jacobi(a):
    """Two-sided diagonal (Jacobi) scaling: (d, dinv, D a D) with
    D = diag(a)^-1/2.  Rows whose diagonal sits at the roundoff floor
    (< n eps dmax) are dropped (d = 0); kept entries are clamped to the
    Cauchy-Schwarz bound |scaled| <= 1."""
    dscale = torch.diagonal(a).real
    dmax = dscale.abs().max()
    eps = torch.finfo(dscale.dtype).eps
    dok = dscale > (a.shape[-1] * eps) * dmax
    safe = torch.where(dok, dscale, torch.ones_like(dscale))
    zero = torch.zeros_like(dscale)
    d = torch.where(dok, 1.0 / torch.sqrt(safe), zero)
    dinv = torch.where(dok, torch.sqrt(safe), zero)
    a_s = a * d[:, None] * d[None, :]
    a_s = a_s / torch.clamp(a_s.abs(), min=1.0)
    return d, dinv, a_s


def _ridge_factor(a, rcond):
    """Cholesky factor of D a D + lam I.  Returns (d, dinv, chol, lam).

    lam starts at rcond * max(diag(D a D)) and grows by 10x (at most 8
    times) until the shifted matrix factors; when it had to grow, one more
    decade of margin is added (see the JAX package for the reasoning)."""
    d, dinv, a_s = _jacobi(a)
    lam = float(rcond * torch.diagonal(a_s).real.max())
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol, info = torch.linalg.cholesky_ex(a_s + lam * eye)
    nesc = 0
    while int(info) != 0 and nesc < 8:
        lam *= 10.0
        nesc += 1
        chol, info = torch.linalg.cholesky_ex(a_s + lam * eye)
    if nesc:
        lam *= 10.0
        chol = torch.linalg.cholesky(a_s + lam * eye)
    return d, dinv, chol, lam


def _refine_default(refine):
    return 0 if refine is None else int(refine)


def half_factor_data(a, method="ridge", rcond=1e-10, refine=None):
    """Split fitting operator as plain tensors: ``(d, chol, p, rank)``.

    ``p`` is the refinement polynomial sum_{j<=refine} G^j with the
    analytic G = I - S0 A = lam D (C C^H)^{-1} D^{-1}."""
    _check_method(method)
    refine = _refine_default(refine)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    d, dinv, chol, lam = _ridge_factor(a, rcond)
    p = eye
    if refine:
        t = torch.linalg.solve_triangular(chol, eye, upper=False)
        t = torch.linalg.solve_triangular(chol.conj().T, t, upper=True)
        g = lam * (d[:, None] * t * dinv[None, :])
        term = eye
        for _ in range(refine):
            term = term @ g
            p = p + term
    return d, chol, p, n


def half_apply(data, b):
    """H b = C^{-1} D b for b (nip, m)."""
    d, chol, _, _ = data
    return torch.linalg.solve_triangular(chol, d[:, None] * b, upper=False)


def half_apply_rows(data, bt):
    """(H b)^T for b given by its transpose ``bt`` (m, nip): the grid-major
    layout of the RHS sweep.  ``bt`` is scaled by D in place."""
    d, chol, _, _ = data
    bt.mul_(d[None, :])
    # X C^T = bt D  <=>  X = (C^{-1} D b)^T
    return torch.linalg.solve_triangular(chol.T, bt, upper=True, left=False)


def finish_apply(data, m_in):
    """P (H^H m_in H) P^H = P D C^{-H} m_in C^{-1} D P^H."""
    d, chol, p, _ = data
    ch = chol.conj().T
    t = torch.linalg.solve_triangular(ch, m_in, upper=True)
    t = torch.linalg.solve_triangular(ch, t.conj().T, upper=True)
    w0 = d[:, None] * t.conj().T * d[None, :]
    return p @ w0 @ p.conj().T


def ridge_operator(a, rcond=1e-10, refine=None):
    """Tikhonov-regularised Cholesky solve operator
    ``apply(b) = (D a D + lam I)^-1``-based solve with optional iterative
    refinement against ``a``.  Returns (apply, rank=n)."""
    refine = _refine_default(refine)
    d, _, chol, _ = _ridge_factor(a, rcond)

    def apply_base(rhs):
        u = torch.linalg.solve_triangular(chol, d[:, None] * rhs,
                                          upper=False)
        out = torch.linalg.solve_triangular(chol.conj().T, u, upper=True)
        return d[:, None] * out

    def apply(rhs):
        z = apply_base(rhs)
        for _ in range(refine):
            z = z + apply_base(rhs - a @ z)
        return z

    return apply, a.shape[-1]


def fitting_half_operator(a, method="ridge", rcond=1e-10, refine=None):
    """Split form S = H^H H: returns ``(half, finish, rank)`` with
    ``half(b) = H b`` and ``finish(m) = P (H^H m H) P^H`` (see
    :func:`half_factor_data`)."""
    data = half_factor_data(a, method=method, rcond=rcond, refine=refine)
    return (lambda b: half_apply(data, b),
            lambda m: finish_apply(data, m), data[3])
