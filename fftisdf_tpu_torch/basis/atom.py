"""Radial atomic DFT: all-electron LDA and GTH pseudo-atom on one grid.

Purpose: first-principles provenance checking of the embedded GTH
pseudopotential tables (``basis/data.py``).  The GTH/HGH parameterizations
(Goedecker-Teter-Hutter PRB 54, 1703 (1996); Hartwigsen-Goedecker-Hutter
PRB 58, 3641 (1998)) were FITTED so that the pseudo-atom reproduces the
all-electron LDA valence eigenvalues (and valence charges) of the neutral
atom.  Re-running both sides of that fit in-repo therefore discriminates a
genuine table from a corrupted transcription: a genuine entry reproduces
the AE valence spectrum to ~1e-3 Ha (limited here by the non-relativistic
treatment), while a wrong digit in ``h_ij`` or ``cloc`` shifts eigenvalues
by >~1e-2 Ha.  Calibration on the independently-verified H/C/O/Si tables
is gated in ``tests/test_atom.py``.

The reference reaches its pseudopotential data through PySCF
(``cell.pseudo='gth-pade'``, ``/root/reference/fftisdf.py:424``); this
module is the native-path provenance tool that PySCF's curated data files
made unnecessary there.

Method: the classic sqrt mesh — uniform grid in s = sqrt(r) (Herman-
Skillman style), which resolves the nuclear region of u(r) = r R(r) while
keeping the discretized operator well-conditioned (a log mesh makes the
symmetrized matrix norm ~1/r0^2 ~ 1e15 and dense eigensolvers carry
ABSOLUTE error eps*||A|| — tested and rejected).  With u = s^(1/2) w(s)
the radial Kohn-Sham equation becomes the symmetric generalized problem

    [-d^2/ds^2 + (3/4 + 4 l(l+1))/s^2 + 8 s^2 v(r)] w = eps * 8 s^2 w ,

solved by dense 4th-order finite differences; exact hydrogenic gates in
``tests/test_atom.py`` pin the discretization error.  The LDA is the
Teter-Pade fit (the functional the GTH tables were generated with; its
rs->0 coefficient a0 = (3/4)(3/2pi)^(2/3) is the exact exchange constant).
Spin-restricted with (possibly fractional) spherically averaged
occupations, exactly like the GTH atomic fits.

Host-side numpy/scipy tool (setup/validation tier, like the C++ lattice
engine's image lists — not the device compute path).  The port's copy of
the JAX package's ``fftisdf_tpu/basis/atom.py``, equal to the bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.linalg import eig_banded, eigh
from scipy.special import erf, gammaln

from fftisdf_tpu_torch.basis.data import (ATOMIC_NUMBER, GTHPseudo,
                                          element_symbol, load_pseudo)

__all__ = [
    "RadialGrid", "AtomResult", "solve_atom", "ae_occupations",
    "pseudo_occupations", "teter_pade_exc", "compare_pseudo",
    "fit_radial_gaussians",
]

# Teter 93 Pade fit of LDA exchange-correlation (the LDA the GTH/HGH tables
# were generated with; coefficients as in the original Goedecker-Teter-
# Hutter code and ABINIT ixc=1).  a0 equals the exact exchange constant
# (3/4)(3/(2 pi))^(2/3) — an internal consistency anchor asserted in tests.
_TP_A = (0.4581652932831429, 2.217058676663745,
         0.7405551735357053, 0.01968227878617998)
_TP_B = (1.0, 4.504130959426697, 1.110667363742916, 0.02359291751427506)


def teter_pade_exc(n):
    """Teter-Pade LDA: (exc(n), vxc(n)) per point, n >= 0."""
    n = np.maximum(np.asarray(n, dtype=np.float64), 1e-30)
    rs = (3.0 / (4.0 * np.pi * n)) ** (1.0 / 3.0)
    a0, a1, a2, a3 = _TP_A
    b1, b2, b3, b4 = _TP_B
    num = a0 + rs * (a1 + rs * (a2 + rs * a3))
    den = rs * (b1 + rs * (b2 + rs * (b3 + rs * b4)))
    exc = -num / den
    dnum = a1 + rs * (2.0 * a2 + rs * 3.0 * a3)
    dden = b1 + rs * (2.0 * b2 + rs * (3.0 * b3 + rs * 4.0 * b4))
    dexc = -(dnum * den - num * dden) / (den * den)
    vxc = exc - rs / 3.0 * dexc
    return exc, vxc


@dataclass
class RadialGrid:
    """Sqrt mesh: s_k = (k+1) ds uniform, r_k = s_k^2, k = 0..n-1."""
    rmax: float = 40.0
    n: int = 2000

    def __post_init__(self):
        self.ds = np.sqrt(self.rmax) / (self.n + 1)
        self.s = self.ds * np.arange(1, self.n + 1)
        self.r = self.s ** 2

    def integrate(self, f):
        """int f(r) dr = int f * 2s ds (trapezoid; f -> 0 at both ends
        assumed for the half-cell corrections)."""
        return float(np.sum(f * 2.0 * self.s) * self.ds)

    def cumint(self, f):
        """F(r_k) = int_0^{r_k} f dr (cumulative trapezoid, f(0)*2s -> 0)."""
        g = f * 2.0 * self.s
        out = np.empty(self.n)
        out[0] = 0.5 * g[0] * self.ds
        out[1:] = out[0] + np.cumsum(0.5 * (g[1:] + g[:-1]) * self.ds)
        return out


def _d2_matrix(n, h):
    """4th-order finite-difference d^2/ds^2, Dirichlet ends (symmetric)."""
    d = np.zeros((n, n))
    i = np.arange(n)
    d[i, i] = -30.0
    d[i[:-1], i[:-1] + 1] = d[i[:-1] + 1, i[:-1]] = 16.0
    d[i[:-2], i[:-2] + 2] = d[i[:-2] + 2, i[:-2]] = -1.0
    return d / (12.0 * h * h)


def _gth_vloc(ps: GTHPseudo, r):
    t2 = (r / ps.rloc) ** 2
    v = -ps.zion / r * erf(r / (np.sqrt(2.0) * ps.rloc))
    if len(ps.cloc):
        poly = np.zeros_like(r)
        for i, c in enumerate(ps.cloc):
            poly += c * t2 ** i
        v = v + np.exp(-0.5 * t2) * poly
    return v


def _gth_projector(l, i, rl, r):
    """HGH radial projector p_{i+1}^l(r) (i 0-based), unit-normalized:
    int p^2 r^2 dr = 1 (HGH eq. 3)."""
    a = l + 2.0 * i + 1.5
    norm = np.sqrt(2.0) * np.exp(-0.5 * gammaln(a)) / rl ** a
    return norm * r ** (l + 2 * i) * np.exp(-0.5 * (r / rl) ** 2)


@dataclass
class AtomResult:
    grid: RadialGrid
    eps: dict                      # {l: (nstate,) eigenvalues}
    u: dict                        # {l: (nstate, npts) radial u = r R}
    occ: dict                      # {l: [occupations]}
    e_tot: float
    rho: np.ndarray                # radial density sum occ u^2 (= 4 pi r^2 n)
    converged: bool
    history: list = field(default_factory=list)
    v_eff: np.ndarray | None = None   # converged screening potential
                                      # v_H + v_xc (pass as solve_atom
                                      # v_init to warm-start fitting loops)


# spherically-averaged ground-state configurations {l: [occ, lowest first]}
_AE_CONFIG = {
    "H": {0: [1.0]}, "He": {0: [2.0]},
    "Li": {0: [2.0, 1.0]}, "Be": {0: [2.0, 2.0]},
    "B": {0: [2.0, 2.0], 1: [1.0]}, "C": {0: [2.0, 2.0], 1: [2.0]},
    "N": {0: [2.0, 2.0], 1: [3.0]}, "O": {0: [2.0, 2.0], 1: [4.0]},
    "F": {0: [2.0, 2.0], 1: [5.0]}, "Ne": {0: [2.0, 2.0], 1: [6.0]},
    "Na": {0: [2.0, 2.0, 1.0], 1: [6.0]},
    "Mg": {0: [2.0, 2.0, 2.0], 1: [6.0]},
    "Al": {0: [2.0, 2.0, 2.0], 1: [6.0, 1.0]},
    "Si": {0: [2.0, 2.0, 2.0], 1: [6.0, 2.0]},
    "P": {0: [2.0, 2.0, 2.0], 1: [6.0, 3.0]},
    "S": {0: [2.0, 2.0, 2.0], 1: [6.0, 4.0]},
    "Cl": {0: [2.0, 2.0, 2.0], 1: [6.0, 5.0]},
    "Ar": {0: [2.0, 2.0, 2.0], 1: [6.0, 6.0]},
    "Ni": {0: [2.0, 2.0, 2.0, 2.0], 1: [6.0, 6.0], 2: [8.0]},
    "Cu": {0: [2.0, 2.0, 2.0, 1.0], 1: [6.0, 6.0], 2: [10.0]},
    "Zn": {0: [2.0, 2.0, 2.0, 2.0], 1: [6.0, 6.0], 2: [10.0]},
}

# aufbau shell order as l sequence: 1s 2s 2p 3s 3p 4s 3d 4p 5s 4d
_SHELL_ORDER_L = [0, 0, 1, 0, 1, 0, 2, 1, 0, 2]


def ae_occupations(symbol: str) -> dict:
    sym = element_symbol(symbol)
    if sym not in _AE_CONFIG:
        raise KeyError(f"no stored ground-state configuration for {sym!r}")
    return {l: list(v) for l, v in _AE_CONFIG[sym].items()}


def pseudo_occupations(symbol: str, ps: GTHPseudo) -> dict:
    """Valence occupations for the pseudo-atom: the AE configuration with
    full core shells stripped in aufbau order until sum(occ) == zion."""
    occ = ae_occupations(symbol)
    ncore = ATOMIC_NUMBER[element_symbol(symbol)] - ps.zion
    if abs(ncore - round(ncore)) > 1e-9 or ncore < -1e-9:
        raise ValueError(f"non-integer core charge {ncore}")
    ncore = int(round(ncore))
    for l in _SHELL_ORDER_L:
        if ncore == 0:
            break
        if occ.get(l):
            take = occ[l][0]
            full = 2.0 * (2 * l + 1)
            if abs(take - full) > 1e-9 or take > ncore + 1e-9:
                raise ValueError(
                    f"core stripping for {symbol} q{ps.zion} would split "
                    f"an open shell (l={l}, occ={take})")
            occ[l].pop(0)
            ncore -= int(round(take))
    if ncore != 0:
        raise ValueError(f"could not strip {ncore} core electrons")
    return {l: v for l, v in occ.items() if v}


def solve_atom(symbol: str, pseudo: GTHPseudo | str | None = None,
               occ: dict | None = None, grid: RadialGrid | None = None,
               xc="teter-pade", mix=0.35, tol=1e-9, max_cycle=300,
               coulomb=True, v_init: np.ndarray | None = None):
    """Spin-restricted radial LDA atom; all-electron if ``pseudo`` is None.

    ``occ``: {l: [occupations, lowest state first]}; defaults to the stored
    ground-state configuration (AE) or the zion-stripped valence (pseudo).
    ``xc``: 'teter-pade' or None; ``coulomb=False`` additionally drops the
    Hartree term (bare external potential — the exact hydrogenic gates).
    ``v_init``: optional screening potential v_H + v_xc from a previous
    solve (``AtomResult.v_eff - v_ext`` of a nearby problem) — warm-starts
    the SCF, the fitting loop's main cost lever (basis/fit.py).
    Returns :class:`AtomResult`.
    """
    sym = element_symbol(symbol)
    z = float(ATOMIC_NUMBER[sym])
    if isinstance(pseudo, str):
        pseudo = load_pseudo(pseudo, sym)
    if occ is None:
        occ = (ae_occupations(sym) if pseudo is None
               else pseudo_occupations(sym, pseudo))
    if grid is None:
        grid = RadialGrid(rmax=40.0, n=2400 if pseudo is None else 1600)
    r, s, ds, n = grid.r, grid.s, grid.ds, grid.n

    v_ext = -z / r if pseudo is None else _gth_vloc(pseudo, r)

    # separable nonlocal part in the w-basis: the u-equation term
    # sum_ij r p_i(r) h_ij <p_j| u>  with  <p_j|u> = int p_j u r dr
    # becomes (after * 8 s^2 / s^(1/2) and u = s^(1/2) w, dr = 2s ds)
    # A += W h W^T,  W[:, i] = 4 sqrt(ds) s^(7/2) p_i(r)
    nonloc = {}
    if pseudo is not None:
        for l, rl, hmat in pseudo.projectors:
            ni = hmat.shape[0]
            if ni == 0:
                continue
            w = np.stack([4.0 * np.sqrt(ds) * s ** 3.5
                          * _gth_projector(l, i, rl, r)
                          for i in range(ni)], axis=1)      # (n, ni)
            nonloc[l] = (w, np.asarray(hmat, dtype=np.float64))

    b = 8.0 * s ** 2                            # B = diag(8 s^2)
    sb = np.sqrt(b)
    lmax = max(occ.keys())
    nst = {l: len(v) for l, v in occ.items()}
    # 5-banded FD coefficients of A = -d2/ds^2 + diag(...)
    c0, c1, c2 = 30.0 / (12 * ds * ds), -16.0 / (12 * ds * ds), 1.0 / (12 * ds * ds)
    d2_dense = None                             # built lazily (nonlocal only)

    def solve_channels(v_eff):
        nonlocal d2_dense
        eps_d, u_d = {}, {}
        diag0 = c0 + 0.75 / s ** 2 + b * v_eff
        for l in range(lmax + 1):
            if l not in occ:
                continue
            diag = diag0 + 4.0 * l * (l + 1.0) / s ** 2
            if l not in nonloc:
                # banded path: B^{-1/2} A B^{-1/2} keeps the bandwidth
                ab = np.zeros((3, n))
                ab[2] = diag / b
                ab[1, 1:] = c1 / (sb[1:] * sb[:-1])
                ab[0, 2:] = c2 / (sb[2:] * sb[:-2])
                vals, vecs = eig_banded(ab, lower=False, select="i",
                                        select_range=(0, nst[l] - 1))
            else:
                if d2_dense is None:
                    d2_dense = _d2_matrix(n, ds)
                wl, hmat = nonloc[l]
                # -d2_dense already carries +c0 on its diagonal
                a = -d2_dense + np.diag(diag - c0) + wl @ hmat @ wl.T
                at = a / sb[:, None] / sb[None, :]
                vals, vecs = eigh(at, subset_by_index=[0, nst[l] - 1])
            u = np.sqrt(s)[:, None] * (vecs / sb[:, None])  # u = s^(1/2) w
            norms = np.sqrt(np.sum(u * u * (2.0 * s)[:, None], axis=0) * ds)
            u /= norms[None, :]
            eps_d[l], u_d[l] = vals, u.T
        return eps_d, u_d

    def density(u_d):
        rho = np.zeros(n)
        for l, occs in occ.items():
            for i, o in enumerate(occs):
                rho += o * u_d[l][i] ** 2
        return rho

    def hartree(rho):
        # V_H(r) = Q(r)/r + int_r^inf rho/r' dr'
        q = grid.cumint(rho)
        outer = grid.cumint(rho / r)
        return q / r + (outer[-1] - outer)

    def xc_eval(rho):
        if xc is None:
            return np.zeros(n), np.zeros(n)
        if xc == "teter-pade":
            return teter_pade_exc(rho / (4.0 * np.pi * r ** 2))
        raise ValueError(f"unknown xc {xc!r}")

    def energy(eps_d, rho, v_h, exc, vxc):
        e_band = sum(float(np.dot(occ[l], eps_d[l])) for l in occ)
        return (e_band - 0.5 * grid.integrate(v_h * rho)
                + grid.integrate((exc - vxc) * rho))

    v_eff = v_ext if v_init is None else v_ext + v_init
    rho = None
    e_prev, conv, hist = np.inf, False, []
    prev_in, prev_res = None, None
    for it in range(max_cycle):
        eps_d, u_d = solve_channels(v_eff)
        rho_out = density(u_d)
        if rho is None:
            rho = rho_out
        else:
            # depth-1 Anderson acceleration on the density
            res = rho_out - rho
            if prev_res is not None:
                dres = res - prev_res
                nrm = float(np.dot(dres, dres))
                beta = float(np.dot(res, dres)) / nrm if nrm > 0 else 0.0
                beta = np.clip(beta, -2.0, 2.0)
                rho_in_b = (1 - beta) * rho + beta * prev_in
                res_b = (1 - beta) * res + beta * prev_res
            else:
                rho_in_b, res_b = rho, res
            prev_in, prev_res = rho, res
            rho = np.maximum(rho_in_b + mix * res_b, 0.0)
        v_h = hartree(rho) if coulomb else np.zeros(n)
        exc, vxc = xc_eval(rho)
        v_eff = v_ext + v_h + vxc
        e_tot = energy(eps_d, rho, v_h, exc, vxc)
        hist.append(e_tot)
        if abs(e_tot - e_prev) < tol and it > 3:
            conv = True
            break
        e_prev = e_tot

    # final pass at the converged potential (consistent eps/rho/energy)
    eps_d, u_d = solve_channels(v_eff)
    rho = density(u_d)
    v_h = hartree(rho) if coulomb else np.zeros(n)
    exc, vxc = xc_eval(rho)
    e_tot = energy(eps_d, rho, v_h, exc, vxc)

    return AtomResult(grid=grid, eps=eps_d, u=u_d, occ=occ, e_tot=e_tot,
                      rho=rho, converged=conv, history=hist,
                      v_eff=v_h + vxc if coulomb or xc else None)


def fit_radial_gaussians(u: np.ndarray, l: int, exps, grid: RadialGrid):
    """Least-squares expansion of a radial state in Gaussian primitives.

    Fits R(r) = u(r)/r in the unit-normalized primitive set
    g_i(r) = N_i r^l exp(-a_i r^2) by minimizing int r^2 (R - sum c_i g_i)^2
    dr: the Gram matrix is analytic (gaussian_int), the cross term a grid
    quadrature.  Returns (coeffs, residual) with residual the L2 fraction
    of u outside span{g_i} (0 for an exactly representable state).

    The coefficient convention matches the embedded basis tables
    (``gto.normalized_coeffs``: columns multiply unit-normalized
    primitives), so the result can be registered directly — the radial
    route of examples/derive_atomic_basis.py.
    """
    from fftisdf_tpu_torch.basis.gto import gaussian_int, gto_norm

    exps = np.asarray(exps, dtype=np.float64)
    norms = gto_norm(l, exps)
    gram = (norms[:, None] * norms[None, :]
            * gaussian_int(2 * l + 2, exps[:, None] + exps[None, :]))
    g = norms[:, None] * grid.r[None, :] ** l * np.exp(
        -exps[:, None] * grid.r[None, :] ** 2)
    b = np.array([grid.integrate(grid.r * gi * u) for gi in g])
    c = np.linalg.solve(gram, b)
    nrm2 = grid.integrate(u * u)
    res2 = max(nrm2 - float(b @ c), 0.0) / nrm2
    return c, np.sqrt(res2)


def compare_pseudo(symbol: str, pseudo: GTHPseudo | str | None = None,
                   **kw):
    """All-electron vs GTH pseudo-atom valence eigenvalues.

    Returns dict with 'ae'/'pp' eigenvalue maps keyed (i, l) within the
    valence window (AE indices shifted past the core states) and 'maxerr'
    — the provenance discriminator: genuine GTH tables land at ~1e-3 Ha,
    corrupted transcriptions at >~1e-2 Ha (calibrated in tests/test_atom.py
    on the independently-verified H/C/O/Si entries).
    """
    sym = element_symbol(symbol)
    ps = pseudo if pseudo is not None else "gth-pade"
    if isinstance(ps, str):
        ps = load_pseudo(ps, sym)
    ae = solve_atom(sym, **kw)
    pp = solve_atom(sym, pseudo=ps, **kw)
    errs, ae_map, pp_map = {}, {}, {}
    for l, occs in pp.occ.items():
        ncore = len(ae.occ.get(l, [])) - len(occs)
        for i in range(len(occs)):
            e_ae = float(ae.eps[l][ncore + i])
            e_pp = float(pp.eps[l][i])
            ae_map[(i, l)], pp_map[(i, l)] = e_ae, e_pp
            errs[(i, l)] = e_pp - e_ae
    return dict(ae=ae_map, pp=pp_map, errs=errs,
                maxerr=max(abs(v) for v in errs.values()),
                e_tot_ae=ae.e_tot, e_tot_pp=pp.e_tot,
                converged=ae.converged and pp.converged)
