"""GTO normalization and real solid harmonics.

The port's copy of the JAX package's ``fftisdf_tpu/basis/gto.py``.  Native
replacement for the normalization conventions underlying PySCF's
``pbc_eval_gto("GTOval")`` (used at ``fftisdf.py:367``).

AO definition used throughout this framework::

    chi_{lmc}(r) = S_lm(r - A) * sum_p  c[p, c] * N(l, a_p) * exp(-a_p |r-A|^2)

where ``S_lm`` is the *real solid harmonic* (homogeneous polynomial of degree
l, carrying the angular normalization sqrt((2l+1)/4pi)-style factors),
``N(l, a)`` the radial primitive norm, and the contracted coefficient column
is renormalized so the contracted AO has unit norm.  m runs over -l..l for
every l (documented deviation from PySCF, which special-cases l=1 to x,y,z
ordering; the mapping is a fixed permutation per shell).
"""
from __future__ import annotations

import math

import numpy as np


def gaussian_int(n: int, alpha) -> np.ndarray:
    """int_0^inf r^n exp(-alpha r^2) dr = Gamma((n+1)/2) / (2 alpha^((n+1)/2))."""
    n1 = (n + 1) * 0.5
    return math.gamma(n1) / (2.0 * np.asarray(alpha) ** n1)


def gto_norm(l: int, alpha) -> np.ndarray:
    """Radial norm: 1/sqrt(int r^2 (r^l e^{-a r^2})^2 dr)."""
    return 1.0 / np.sqrt(gaussian_int(2 * l + 2, 2.0 * np.asarray(alpha)))


def normalized_coeffs(l: int, exps: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Fold primitive norms into the contraction and normalize each contracted
    function to unit self-overlap (matching the common GTO convention)."""
    exps = np.asarray(exps, dtype=np.float64)
    c = np.asarray(coeffs, dtype=np.float64) * gto_norm(l, exps)[:, None]
    # contracted self-overlap: S_c = sum_pq c_p c_q gint(2l+2, ap+aq)
    ee = exps[:, None] + exps[None, :]
    sprim = gaussian_int(2 * l + 2, ee)
    s = np.einsum("pc,qc,pq->c", c, c, sprim)
    return c / np.sqrt(s)[None, :]


# real solid harmonics S_lm, m = -l..l; polynomial coefficients include the
# angular normalization so that integral over the unit sphere of
# (S_lm(rhat))^2 dOmega = 1 when combined with gto_norm's radial part.
_SPH_COEF = {
    0: 0.28209479177387814,          # 1/sqrt(4pi)
    1: 0.4886025119029199,           # sqrt(3/4pi)
}


def real_solid_harmonics(dx, dy, dz, l: int, xp):
    """Return list of 2l+1 arrays S_lm(d), m=-l..l. `xp` is numpy or torch."""
    if l == 0:
        one = xp.ones_like(dx)
        return [0.28209479177387814 * one]
    if l == 1:
        c = 0.4886025119029199
        return [c * dy, c * dz, c * dx]
    x2, y2, z2 = dx * dx, dy * dy, dz * dz
    if l == 2:
        c1 = 1.0925484305920792
        return [
            c1 * dx * dy,
            c1 * dy * dz,
            0.31539156525252005 * (2.0 * z2 - x2 - y2),
            c1 * dx * dz,
            0.5462742152960396 * (x2 - y2),
        ]
    if l == 3:
        return [
            0.5900435899266435 * dy * (3.0 * x2 - y2),
            2.890611442640554 * dx * dy * dz,
            0.4570457994644658 * dy * (4.0 * z2 - x2 - y2),
            0.3731763325901154 * dz * (2.0 * z2 - 3.0 * x2 - 3.0 * y2),
            0.4570457994644658 * dx * (4.0 * z2 - x2 - y2),
            1.445305721320277 * dz * (x2 - y2),
            0.5900435899266435 * dx * (x2 - 3.0 * y2),
        ]
    if l == 4:
        r2 = x2 + y2 + z2
        return [
            2.5033429417967046 * dx * dy * (x2 - y2),
            1.7701307697799304 * dy * dz * (3.0 * x2 - y2),
            0.9461746957575601 * dx * dy * (7.0 * z2 - r2),
            0.6690465435572892 * dy * dz * (7.0 * z2 - 3.0 * r2),
            0.10578554691520431 * (35.0 * z2 * z2 - 30.0 * z2 * r2 + 3.0 * r2 * r2),
            0.6690465435572892 * dx * dz * (7.0 * z2 - 3.0 * r2),
            0.47308734787878004 * (x2 - y2) * (7.0 * z2 - r2),
            1.7701307697799304 * dx * dz * (x2 - 3.0 * y2),
            0.6258357354491761 * (x2 * x2 - 6.0 * x2 * y2 + y2 * y2),
        ]
    raise NotImplementedError(f"l={l} not supported (max l=4)")


def shell_rcut(l: int, exps, coeffs, precision: float) -> float:
    """Radius beyond which the contracted AO is below `precision`.

    Solves |c_max| * r^l * exp(-a_min r^2) = precision approximately
    (two fixed-point iterations, as is standard)."""
    exps = np.asarray(exps)
    c = np.abs(np.asarray(coeffs) * gto_norm(l, exps)[:, None]).max()
    amin = float(exps.min())
    c = max(c, 1.0)
    r = np.sqrt(max(np.log(c / precision), 5.0) / amin)
    for _ in range(2):
        r = np.sqrt(max(np.log(c * max(r, 1.0) ** l / precision), 5.0) / amin)
    return float(r)
