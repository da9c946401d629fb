"""Greedy pivoted (rank-revealing) Cholesky on the device.

Counterpart of ``fftisdf_tpu/linalg/pivoted_cholesky.py::pivoted_cholesky``.
Everything stays in original index order: the Schur-complement diagonal
``d`` and the factor rows ``L[j, :]`` are kept, and each step is one argmax,
one row gather, one (j, n) matvec and a rank-1 diagonal update.  The pivot
index never leaves the device inside the loop, so the loop launches kernels
without waiting on the device.
"""
from __future__ import annotations

import torch


def pivoted_cholesky(a, tol=None, max_rank=None):
    """Greedy pivoted Cholesky of a hermitian PSD matrix ``a`` (n, n).

    Returns ``(L, piv, rank, diag_hist)``: ``L`` (max_rank, n) with rows in
    original column order (``a ~= L^H L`` when complete), ``piv`` the pivot
    indices in selection order (-1 past numerical exhaustion), ``rank`` the
    number of pivots whose Schur diagonal exceeded ``tol`` (a python int),
    and ``diag_hist[j]`` the pivot magnitude at step j.

    ``tol=None`` uses the dpstrf-style default ``n * eps * max|diag|``."""
    n = a.shape[0]
    max_rank = n if max_rank is None else int(min(max_rank, n))
    rdtype = a.real.dtype if a.is_complex() else a.dtype
    d = torch.diagonal(a).real.to(rdtype).clone()
    if tol is None:
        tol = n * torch.finfo(rdtype).eps * d.abs().max()
    tol = torch.as_tensor(tol, dtype=rdtype, device=a.device)
    # ties: candidates within the roundoff window n eps max(diag) of the
    # largest Schur diagonal are equal to working precision (symmetry-
    # equivalent grid points); the lowest index among them is taken, so the
    # pivot order does not depend on the backend's summation order
    tie = n * torch.finfo(rdtype).eps * d.abs().max()
    L = torch.zeros((max_rank, n), dtype=a.dtype, device=a.device)
    piv = torch.full((max_rank,), -1, dtype=torch.int64, device=a.device)
    hist = torch.zeros((max_rank,), dtype=rdtype, device=a.device)
    neg_inf = torch.tensor(-float("inf"), dtype=rdtype, device=a.device)
    tiny = torch.tensor(1e-300, dtype=rdtype, device=a.device)
    for j in range(max_rank):
        near = (d >= d.max() - tie).to(torch.int8)
        i = torch.argmax(near).reshape(1)
        dmax = d.index_select(0, i)
        # residual of row i: a[i, :] - sum_m conj(L[m, i]) L[m, :]
        row = a.index_select(0, i)[0]
        if j:
            row = row - L[:j].index_select(1, i)[:, 0].conj() @ L[:j]
        ok = dmax > 0
        lj = row / torch.sqrt(torch.maximum(dmax, tiny))
        # once dmax <= 0 (numerical exhaustion) the factor row is zero and
        # the point is not retired
        lj = torch.where(ok, lj, torch.zeros_like(lj))
        d = d - (lj * lj.conj()).real
        d.index_copy_(0, i, torch.where(ok, neg_inf, dmax))
        L[j] = lj
        piv[j:j + 1] = torch.where(ok, i, torch.full_like(i, -1))
        hist[j:j + 1] = dmax
    rank = int((hist > tol).sum())
    return L, piv, rank, hist
