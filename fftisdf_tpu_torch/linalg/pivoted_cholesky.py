"""Greedy pivoted (rank-revealing) Cholesky on the device.

Counterpart of ``fftisdf_tpu/linalg/pivoted_cholesky.py``.

:func:`pivoted_cholesky` and :func:`pivot_selection` take the dense matrix.
Everything stays in original index order: the Schur-complement diagonal
``d`` and the factor rows ``L[j, :]`` are kept, and each step is one argmax,
one row gather, one (j, n) matvec and a rank-1 diagonal update.  The pivot
index never leaves the device inside the loop, so the loop launches kernels
without waiting on the device.

:func:`pivoted_cholesky_pairgram` factors the squared pair gram of an AO
matrix without ever forming it: only the pivots' gram rows are generated,
one panel per block of candidates.  :func:`pivoted_cholesky_np` is the
plain host loop the tests hold the others against.

Ties: candidates within ``n eps max(diag)`` of the largest Schur diagonal,
with the eps of the dtype in hand, are equal to working precision
(symmetry-equivalent grid points); the lowest index among them is taken,
so the pivot order does not depend on the backend's summation order.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _pivoted_cholesky_impl(a, tol, max_rank, keep_indefinite):
    n = a.shape[0]
    rdtype = a.real.dtype if a.is_complex() else a.dtype
    eps = torch.finfo(rdtype).eps
    d = torch.diagonal(a).real.to(rdtype).clone()
    tol = torch.as_tensor(tol, dtype=rdtype, device=a.device)
    tie0 = n * eps * d.abs().max()
    L = torch.zeros((max_rank, n), dtype=a.dtype, device=a.device)
    piv = torch.full((max_rank,), -1, dtype=torch.int64, device=a.device)
    hist = torch.zeros((max_rank,), dtype=rdtype, device=a.device)
    neg_inf = torch.tensor(-float("inf"), dtype=rdtype, device=a.device)
    tiny = torch.tensor(torch.finfo(rdtype).tiny, dtype=rdtype,
                        device=a.device)
    for j in range(max_rank):
        top = d.max()
        # a selection that continues past the floating-point rank narrows
        # the tie window with the live maximum: below the noise floor the
        # stale diagonal's argmax still spreads the points, where a window
        # fixed at n eps max(diag) would hand them out in index order
        tie = torch.minimum(tie0, n * eps * top.abs()) if keep_indefinite \
            else tie0
        near = (d >= top - tie).to(torch.int8)
        i = torch.argmax(near).reshape(1)
        dmax = d.index_select(0, i)
        # residual of row i: a[i, :] - sum_m conj(L[m, i]) L[m, :]
        row = a.index_select(0, i)[0]
        if j:
            row = row - L[:j].index_select(1, i)[:, 0].conj() @ L[:j]
        ok = dmax > 0
        lj = row / torch.sqrt(torch.maximum(dmax, tiny))
        # once dmax <= 0 (numerical exhaustion) the factor row is zero; the
        # point is retired, and its pivot emitted, only with
        # keep_indefinite
        lj = torch.where(ok, lj, torch.zeros_like(lj))
        d = d - (lj * lj.conj()).real
        if keep_indefinite:
            d.index_fill_(0, i, -float("inf"))
            piv[j:j + 1] = i
        else:
            d.index_copy_(0, i, torch.where(ok, neg_inf, dmax))
            piv[j:j + 1] = torch.where(ok, i, torch.full_like(i, -1))
        L[j] = lj
        hist[j:j + 1] = dmax
    rank = int((hist > tol).sum())
    return L, piv, rank, hist


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
    if tol is None:
        rdtype = a.real.dtype if a.is_complex() else a.dtype
        tol = n * torch.finfo(rdtype).eps * torch.diagonal(a).real.abs().max()
    return _pivoted_cholesky_impl(a, tol, max_rank, keep_indefinite=False)


def pivot_selection(a, max_rank=None, tol=0.0):
    """Pivot indices for point *selection* in a noise-limited dtype: always
    ``max_rank`` distinct pivots in greedy residual-diagonal order,
    continuing past a non-positive Schur diagonal, plus the detected
    numerical rank.  Returns ``(piv, rank, diag_hist)``."""
    n = a.shape[0]
    max_rank = n if max_rank is None else int(min(max_rank, n))
    _, piv, rank, hist = _pivoted_cholesky_impl(a, tol, max_rank,
                                                keep_indefinite=True)
    return piv, rank, hist


def pivoted_cholesky_np(a, tol=None, max_rank=None):
    """Host f64 greedy pivoted Cholesky in numpy (plain argmax, no tie
    window): ``(L, piv, rank, hist)``."""
    a = np.asarray(a, dtype=np.float64)
    n = a.shape[0]
    k = n if max_rank is None else int(min(max_rank, n))
    d = np.ascontiguousarray(np.real(np.diagonal(a)).copy())
    if tol is None:
        tol = n * np.finfo(np.float64).eps * max(d.max(), 0.0)
    L = np.zeros((k, n))
    piv = np.full(k, -1, dtype=np.int64)
    hist = np.zeros(k)
    for j in range(k):
        i = int(np.argmax(d))
        dmax = d[i]
        hist[j] = dmax
        if dmax <= 0:
            break
        lj = (a[i, :] - L[:j, i] @ L[:j, :]) / np.sqrt(dmax)
        d -= lj * lj
        d[i] = -np.inf
        L[j] = lj
        piv[j] = i
    rank = int(np.sum(hist > tol))
    return L, piv, rank, hist


def pivoted_cholesky_pairgram(flat, nk, max_rank, tol=None, block=96):
    """Matrix-free blocked greedy pivoted Cholesky of the squared pair gram
    ``x4 = (Re(flat flat^H))**2 / nk`` on the device of ``flat``; the
    (ng0, ng0) matrix is never formed.

    ``flat`` is the (ng0, ncol) complex or real AO matrix whose rows are
    grid points and whose columns run over (k, ao); a time-reversal
    weighting of the k axis must already be folded into the columns
    (sqrt(w) scaling).  Returns ``(piv, rank, hist)`` as host arrays, with
    the meaning of :func:`pivoted_cholesky`'s (pivots in selection order,
    -1 past numerical exhaustion; rank by ``tol``, default
    ``ng0 eps max(diag)``; the Schur-diagonal history).

    The pivot sequence is the dense greedy algorithm's: candidates are
    taken from the live Schur diagonal in blocks of ``block``, their gram
    rows are generated on the fly (one gemm panel), corrected against the
    existing factor (one gemm), and a candidate is accepted only while it
    is still the pivot the dense algorithm would take; otherwise the block
    is abandoned and chosen anew.  Each accepted pivot costs one small
    fetch (its index and diagonal).

    Cost: O(max_rank ng0 ncol) for the generated rows and
    O(max_rank^2 ng0) for the corrections, against O(ng0^2 ncol) for the
    dense gram.  Memory: the (max_rank, ng0) factor instead of ng0^2."""
    ng0 = flat.shape[0]
    k = int(min(max_rank, ng0))
    dev = flat.device
    if flat.is_complex():
        fre, fim = flat.real.contiguous(), flat.imag.contiguous()
    else:
        fre, fim = flat.contiguous(), None
    rdtype = fre.dtype
    nrm2 = (fre * fre).sum(dim=1)
    if fim is not None:
        nrm2 += (fim * fim).sum(dim=1)
    d = nrm2 * nrm2 / nk
    eps = torch.finfo(rdtype).eps
    tie = ng0 * eps * max(float(d.max()), 0.0)
    if tol is None:
        tol = tie
    L = torch.zeros((k, ng0), dtype=rdtype, device=dev)
    piv = np.full(k, -1, dtype=np.int64)
    hist = np.zeros(k)

    def next_pivot():
        """(index, Schur diagonal) of the pivot the dense algorithm takes
        next, fetched together."""
        near = (d >= d.max() - tie).to(torch.int8)
        i = torch.argmax(near)
        both = torch.stack([i.to(torch.float64), d[i].to(torch.float64)])
        i_h, dmax_h = both.tolist()
        return int(i_h), dmax_h

    j = 0
    exhausted = False
    while j < k and not exhausted:
        i, dmax = next_pivot()
        if not math.isfinite(dmax) or dmax <= 0:
            break
        b = min(block, k - j)
        # candidate block: the top b of the live Schur diagonal, with the
        # next pivot among them (a tie-break can name one outside)
        cand = torch.topk(d, b).indices
        cand_h = cand.tolist()
        if i not in cand_h:
            cand_h[-1] = i
            cand = torch.as_tensor(cand_h, device=dev)
        # their x4 rows, matrix-free: (Re <flat[c], flat[.]>)^2 / nk
        g = fre[cand] @ fre.T
        if fim is not None:
            g += fim[cand] @ fim.T
        g.square_().div_(nk)
        if j:
            g -= L[:j][:, cand].T @ L[:j]
        pos = {c: n for n, c in enumerate(cand_h)}
        taken = 0
        while j < k and taken < b:
            if taken:
                i, dmax = next_pivot()
            if dmax <= 0:
                exhausted = True
                break
            if i not in pos:
                # a point outside the block now leads the diagonal (the
                # candidates fell below it): choose the block anew
                break
            hist[j] = dmax
            lj = g[pos[i]] / math.sqrt(dmax)
            d -= lj * lj
            d[i] = -float("inf")
            L[j] = lj
            piv[j] = i
            # within-block correction of the remaining candidates
            g -= torch.outer(lj[cand], lj)
            j += 1
            taken += 1
    rank = int(np.sum(hist > float(tol)))
    return piv, rank, hist
