"""Fitting-equation solvers: ridge and the eigh family, full and split.

Counterpart of ``fftisdf_tpu/linalg/solvers.py``: the ISDF fit solves
``A z = B`` with ``A = x4_q`` (nip x nip hermitian PSD) per momentum
sector.  ``ridge`` (the default) is a Jacobi-scaled Tikhonov-regularised
Cholesky solve with optional refinement; ``lstsq``, ``pinv`` and ``svd``
reduce to one truncated eigendecomposition of the hermitian ``A`` (``svd``
truncates the raw, unpreconditioned spectrum).

Two operator forms share one factorisation layer:

- full operators (:func:`fitting_operator` / :func:`solve_fitting`) apply
  S ~ A^-1 to a right-hand side;
- the split form S = H^H H (:func:`half_factor_data`, :func:`half_apply`,
  :func:`finish_apply`, :func:`fitting_half_operator`) lets the metric-side
  w_q assembly touch the O(nip^2 ngrid) RHS only twice while keeping
  cond(A)^1 error amplification.  ``H b = C^{-1} D b`` for ridge and
  ``SW V^H D b`` for the eigh family; the finish is ``P (H^H M H) P^H``
  with P the iterative-refinement polynomial (ridge only: for a truncated
  inverse S0 A S0 = S0 and refinement is a no-op).

Defaults follow the dtype in hand: ``refine=None`` is 0 in float64 and 1 in
float32.
"""
from __future__ import annotations

import torch

_EIGH_METHODS = ("lstsq", "pinv", "eigh", "svd")


def _real_dtype(a):
    return a.real.dtype if a.is_complex() else a.dtype


def _default_refine(a, refine):
    if refine is None:
        return 0 if _real_dtype(a) == torch.float64 else 1
    return int(refine)


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
    # detached, as the JAX package's stop_gradient: |.| is not smooth at 0
    # and the clamp only rescales noise-level entries
    a_s = a_s / torch.clamp(a_s.abs().detach(), min=1.0)
    return d, dinv, a_s


def _finite_cholesky(a):
    """(factor, ok): the Cholesky factor of ``a`` and whether LAPACK
    accepted the matrix and every entry of the factor is finite.  Near the
    float32 noise floor a factorisation can report success and still carry
    non-finite entries, so both are checked."""
    chol, info = torch.linalg.cholesky_ex(a)
    ok = (info == 0) & torch.isfinite(torch.view_as_real(chol)
                                      if chol.is_complex() else chol).all()
    return chol, bool(ok)


def _ridge_factor(a, rcond):
    """Cholesky factor of D a D + lam I.  Returns (d, dinv, chol, lam).

    lam starts at rcond * max(diag(D a D)) and grows by 10x (at most 8
    times) until the shifted matrix has a finite factor: the scaled gram is
    PSD in exact arithmetic, but at float32 its eigenvalue noise floor can
    sit below -lam.  When lam had to grow, one more decade of margin is
    added, so that the refinement factor lam / (w + lam) stays below 10/9
    on the noise direction."""
    d, dinv, a_s = _jacobi(a)
    # lam leaves the autograd graph here.  After the Jacobi scaling every
    # kept diagonal entry is 1, so lam = rcond and its derivative is 0 in
    # exact arithmetic; the JAX package stops its gradient too
    lam = float(rcond * torch.diagonal(a_s).real.max().detach())
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    chol, ok = _finite_cholesky(a_s + lam * eye)
    nesc = 0
    while not ok and nesc < 8:
        lam *= 10.0
        nesc += 1
        chol, ok = _finite_cholesky(a_s + lam * eye)
    if nesc:
        lam *= 10.0
        chol = torch.linalg.cholesky(a_s + lam * eye)
    return d, dinv, chol, lam


def _eigh_factor(a, rcond, rank, precondition):
    """Truncated eigh of the (optionally Jacobi-scaled) ``a``.  Returns
    (d, w, v, keep) with ``keep`` the mask of retained eigenvalues:
    w > rcond * max|w| (n eps when ``rcond`` is None) and, with ``rank``,
    only the ``rank`` largest."""
    if precondition:
        d, _, a_s = _jacobi(a)
    else:
        d = torch.ones(a.shape[-1], dtype=_real_dtype(a), device=a.device)
        a_s = a
    w, v = torch.linalg.eigh(a_s)
    wmax = w.abs().max()
    rc = a.shape[-1] * torch.finfo(w.dtype).eps if rcond is None else rcond
    keep = w > rc * wmax
    if rank is not None:
        idx = torch.argsort(w, descending=True)[:int(rank)]
        kmask = torch.zeros_like(keep)
        kmask[idx] = True
        keep = keep & kmask
    return d, w, v, keep


def _inv_kept(w, keep):
    return torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))


def _with_refinement(apply_base, a, refine):
    """A base solve wrapped in fixed-precision iterative refinement; the
    result S + S (I - a S) + ... is hermitian whenever S is."""

    def apply(rhs):
        z = apply_base(rhs)
        for _ in range(refine):
            z = z + apply_base(rhs - a @ z)
        return z

    return apply


def hermitian_operator(a, rcond=None, rank=None, precondition=True,
                       refine=None):
    """Truncated-eigh solve operator for hermitian PSD ``a``, with Jacobi
    preconditioning and iterative refinement (one step in float32 by
    default).  Returns (apply(rhs) -> z, numerical rank)."""
    refine = _default_refine(a, refine)
    d, w, v, keep = _eigh_factor(a, rcond, rank, precondition)
    winv = _inv_kept(w, keep)

    def apply_inv(rhs):
        out = v @ (winv[:, None] * (v.mH @ (d[:, None] * rhs)))
        return d[:, None] * out

    return _with_refinement(apply_inv, a, refine), int(keep.sum())


def hermitian_solve(a, b, rcond=None, rank=None, precondition=True,
                    refine=None):
    """Solve a z = b through :func:`hermitian_operator`: (z, rank)."""
    apply_inv, rank_out = hermitian_operator(
        a, rcond=rcond, rank=rank, precondition=precondition, refine=refine)
    return apply_inv(b), rank_out


def ridge_operator(a, rcond=1e-10, refine=None):
    """Tikhonov-regularised Cholesky solve operator
    ``apply(b) = (D a D + lam I)^-1``-based solve with optional iterative
    refinement against ``a``.  Returns (apply, rank=n)."""
    refine = _default_refine(a, refine)
    d, _, chol, _ = _ridge_factor(a, rcond)

    def apply_base(rhs):
        u = torch.linalg.solve_triangular(chol, d[:, None] * rhs,
                                          upper=False)
        out = torch.linalg.solve_triangular(chol.mH, u, upper=True)
        return d[:, None] * out

    return _with_refinement(apply_base, a, refine), a.shape[-1]


def ridge_solve(a, b, rcond=1e-10, refine=None):
    """Solve through :func:`ridge_operator`: (z, rank)."""
    apply_inv, rank = ridge_operator(a, rcond=rcond, refine=refine)
    return apply_inv(b), rank


def half_factor_data(a, method="ridge", rcond=1e-10, rank=None,
                     precondition=True, refine=None):
    """Split fitting operator as plain tensors:
    ``(kind, d, f1, f2, p, rank)``.

      ridge        kind 'ridge': f1 = chol, f2 = None, p = the refinement
                   polynomial sum_{j<=refine} G^j with the analytic
                   G = I - S0 A = lam D (C C^H)^{-1} D^{-1} (None when
                   refine is 0);
      eigh family  kind 'eigh': f1 = v, f2 = sqrt(1/w) on the kept
                   eigenvalues (0 elsewhere), p = None.
    """
    if method == "ridge":
        refine = _default_refine(a, refine)
        n = a.shape[-1]
        d, dinv, chol, lam = _ridge_factor(a, rcond)
        p = None
        if refine:
            eye = torch.eye(n, dtype=a.dtype, device=a.device)
            t = torch.linalg.solve_triangular(chol, eye, upper=False)
            t = torch.linalg.solve_triangular(chol.mH, t, upper=True)
            g = lam * (d[:, None] * t * dinv[None, :])
            p, term = eye, eye
            for _ in range(refine):
                term = term @ g
                p = p + term
        return "ridge", d, chol, None, p, n
    if method in _EIGH_METHODS:
        d, w, v, keep = _eigh_factor(a, rcond, rank,
                                     precondition and method != "svd")
        return "eigh", d, v, torch.sqrt(_inv_kept(w, keep)), None, \
            int(keep.sum())
    raise ValueError(f"unknown solver {method!r}")


def half_apply(data, b):
    """H b for b (nip, m): C^{-1} D b (ridge) or SW V^H D b (eigh)."""
    kind, d, f1, f2, _, _ = data
    if kind == "ridge":
        return torch.linalg.solve_triangular(f1, d[:, None] * b,
                                             upper=False)
    return f2[:, None] * (f1.mH @ (d[:, None] * b))


def half_apply_rows(data, bt):
    """(H b)^T for b given by its transpose ``bt`` (m, nip): the grid-major
    layout of the RHS sweep.  ``bt`` is scaled by D in place."""
    kind, d, f1, f2, _, _ = data
    bt.mul_(d[None, :])
    if kind == "ridge":
        # X C^T = bt D  <=>  X = (C^{-1} D b)^T
        return torch.linalg.solve_triangular(f1.T, bt, upper=True,
                                             left=False)
    return (bt @ f1.conj()).mul_(f2[None, :])


def finish_apply(data, m_in):
    """P (H^H m_in H) P^H: D C^{-H} m_in C^{-1} D (ridge) or
    D V SW m_in SW V^H D (eigh), then the refinement polynomial."""
    kind, d, f1, f2, p, _ = data
    if kind == "ridge":
        ch = f1.mH
        t = torch.linalg.solve_triangular(ch, m_in, upper=True)
        t = torch.linalg.solve_triangular(ch, t.mH, upper=True).mH
    else:
        t = f1 @ (f2[:, None] * m_in * f2[None, :]) @ f1.mH
    w0 = d[:, None] * t * d[None, :]
    return w0 if p is None else p @ w0 @ p.mH


def fitting_half_operator(a, method="ridge", rcond=1e-10, rank=None,
                          precondition=True, refine=None):
    """Split form S = H^H H: returns ``(half, finish, rank)`` with
    ``half(b) = H b`` and ``finish(m) = P (H^H m H) P^H`` (see
    :func:`half_factor_data`)."""
    data = half_factor_data(a, method=method, rcond=rcond, rank=rank,
                            precondition=precondition, refine=refine)
    return (lambda b: half_apply(data, b),
            lambda m: finish_apply(data, m), data[5])


def fitting_operator(a, method="ridge", rcond=1e-10, rank=None,
                     precondition=True, refine=None):
    """Hermitian solve operator of the fitting normal matrix by solver
    name: (apply, rank).  ``svd`` truncates the raw spectrum and does not
    refine."""
    if method in ("lstsq", "pinv", "eigh"):
        return hermitian_operator(a, rcond=rcond, rank=rank,
                                  precondition=precondition, refine=refine)
    if method == "svd":
        return hermitian_operator(a, rcond=rcond, rank=rank,
                                  precondition=False, refine=0)
    if method == "ridge":
        return ridge_operator(a, rcond=rcond, refine=refine)
    raise ValueError(f"unknown solver {method!r}")


def solve_fitting(a, b, method="ridge", rcond=1e-10, rank=None,
                  precondition=True, refine=None):
    """a: (nip, nip) hermitian PSD; b: (nip, m).  Returns (z, rank)."""
    apply_inv, rank_out = fitting_operator(
        a, method=method, rcond=rcond, rank=rank,
        precondition=precondition, refine=refine)
    return apply_inv(b), rank_out


def whiten_basis(x_k, x4_k, rcond=1e-10):
    """Rotate the interpolation vectors into the eigenbasis of each
    sector's normal matrix (the reference's SVD-whitening variant,
    ``fftdf-with-k-svd-backup.py:84-105``), so that the fitting solve of
    sector q becomes the diagonal scaling ``z_q = scale[q][:, None] *
    y_rot_q^T`` of the linearly rotated RHS ``y_rot_q = y_q v_q``.

    x_k (nk, nip, nao), x4_k (nk, nip, nip).  Returns (x_rot (nk, nip,
    nao), scale (nk, nip)): 1/w on the eigenvalues above ``rcond`` times
    the sector's largest, 0 elsewhere."""
    w, v = torch.linalg.eigh(x4_k)                   # batched over sectors
    keep = w > rcond * w.max(dim=-1, keepdim=True).values
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    x_rot = v.conj().transpose(-1, -2) @ x_k          # kJm = sum_I v*_IJ x_Im
    return x_rot, winv
