"""SCF numerics on the host: DIIS/ADIIS extrapolation and occupations.

Counterpart of ``fftisdf_tpu/scf/core.py`` with numpy as the array
namespace.  The SCF loop's per-k algebra is small (nao x nao) and runs on
the host in float64/complex128, as the JAX package's host SCF loops do;
only J/K run on the device.
"""
from __future__ import annotations

import numpy as np
from scipy.special import erfc


def _real_finfo(dtype):
    return np.finfo(np.dtype(dtype).type(0).real.dtype)


def diis_extrapolate(errs, focks, valid):
    """Pulay-extrapolated Fock from stored (error, fock) rows.

    errs/focks: (m, L) complex rows; valid: (m,) bool mask of live slots.
    Minimises |sum_i c_i err_i|^2 subject to sum_i c_i = 1, with B
    normalised by its largest live element and a relative Tikhonov term."""
    m = errs.shape[0]
    b = np.einsum("il,jl->ij", errs.conj(), errs)
    vv = valid[:, None] & valid[None, :]
    scale = np.max(np.where(vv, np.abs(b), 0.0)) + _real_finfo(b.dtype).tiny
    b = b / scale
    b = np.where(vv, b, np.eye(m, dtype=b.dtype))
    edge = np.where(valid, -1.0, 0.0).astype(b.dtype)
    a = np.concatenate([
        np.concatenate([b, edge[:, None]], axis=1),
        np.concatenate([edge, np.zeros((1,), dtype=b.dtype)])[None, :],
    ], axis=0)
    a = a + 1e-12 * np.eye(m + 1, dtype=b.dtype)
    rhs = np.concatenate([np.zeros((m,), dtype=b.dtype),
                          -np.ones((1,), dtype=b.dtype)])
    coef = np.linalg.solve(a, rhs)[:m] * valid.astype(b.dtype)
    return np.einsum("i,il->l", coef, focks)


def adiis_coeffs(dms, focks, ref, valid, n_steps=400):
    """ADIIS simplex coefficients (Hu & Yang, JCP 132, 054109 (2010)) by
    entropic mirror descent over the convex hull of the stored densities.
    dms/focks: (m, L) flattened complex histories; ``ref`` the slot of the
    current (D, F); valid: (m,) bool.  Returns c (m,) real."""
    rdt = _real_finfo(dms.dtype).dtype
    tiny = _real_finfo(rdt).tiny
    dd = dms - dms[ref][None, :]
    df = focks - focks[ref][None, :]
    vf = valid.astype(rdt)
    a = np.real(np.einsum("il,l->i", dd.conj(), focks[ref])).astype(rdt) * vf
    b = (np.real(np.einsum("il,jl->ij", dd.conj(), df)).astype(rdt)
         * vf[:, None] * vf[None, :])
    scale = np.max(np.abs(a)) + np.max(np.abs(b)) + tiny
    a = a / scale
    b = b / scale
    c = vf / np.sum(vf)
    for t in range(n_steps):
        g = (2.0 * a + (b + b.T) @ c) * vf
        g = g - np.sum(c * g)
        gmax = np.max(np.abs(g) * vf) + tiny
        eta = 2.0 / (1.0 + 0.02 * t)
        c = c * np.exp(-eta * g / gmax) * vf
        c = c / (np.sum(c) + tiny)
    return c


def smeared_occ(e, ok, nelec_target, sigma, method):
    """Fractional occupations from a bisected global chemical potential.
    Returns ``(f, entropy, mu)``; ``ok`` masks valid slots."""
    clip = 600.0
    big = 1e30

    def nelec(mu):
        x = np.clip((e - mu) / sigma, -clip, clip)
        if method == "fermi":
            f = 1.0 / (1.0 + np.exp(x))
        else:
            f = 0.5 * erfc(x)
        f = np.where(ok, f, 0.0)
        return np.sum(f), f

    lo = np.min(np.where(ok, e, big)) - 45.0 * sigma
    hi = np.max(np.where(ok, e, -big)) + 45.0 * sigma
    for _ in range(90):
        mu = 0.5 * (lo + hi)
        n, _ = nelec(mu)
        lo, hi = (np.where(n < nelec_target, mu, lo),
                  np.where(n < nelec_target, hi, mu))
    mu = 0.5 * (lo + hi)
    _, f = nelec(mu)
    if method == "fermi":
        f_lo, f_hi = 1e-300, 1.0 - 1e-16
        fc = np.clip(f, f_lo, f_hi)
        s = -(fc * np.log(fc) + (1.0 - fc) * np.log1p(-fc))
        s = np.where(ok & (f > f_lo) & (f < f_hi), s, 0.0)
    else:
        x = (e - mu) / sigma
        s = np.where(ok, np.exp(-x * x) / (2.0 * np.sqrt(np.pi)), 0.0)
    return f, np.sum(s), mu


def aufbau_occ(e, ok, nocc):
    """0/1 occupations of the ``nocc`` lowest valid states per k row."""
    ee = np.where(ok, e, 1e30)
    rank = np.argsort(np.argsort(ee, axis=-1), axis=-1)
    return ((rank < nocc) & ok).astype(_real_finfo(e.dtype).dtype)


def smeared_occupations(es, nocc, sigma, method="fermi", factor=2.0):
    """Occupations from a global chemical potential over ragged per-k
    spectra ``es``: ``(occs, mu, entropy)`` with sum == factor nocc nk."""
    ns = [len(np.asarray(ek)) for ek in es]
    e = np.full((len(es), max(ns)), 1e30)
    ok = np.zeros((len(es), max(ns)), dtype=bool)
    for i, ek in enumerate(es):
        e[i, :ns[i]] = np.asarray(ek)
        ok[i, :ns[i]] = True
    f, s, mu = smeared_occ(e, ok, float(nocc * len(es)), sigma, method)
    occs = [factor * f[i, :n] for i, n in enumerate(ns)]
    return occs, float(mu), factor * float(s)


def fixed_occupations(es, nocc, factor=2.0):
    """Aufbau 0/factor occupations per k row (ragged input)."""
    out = []
    for ek in es:
        occ = np.zeros(len(np.asarray(ek)))
        occ[:nocc] = factor
        out.append(occ)
    return out
