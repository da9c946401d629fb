"""In-repo GTH pseudopotential refit: the GTH-96 fitting procedure.

The GTH/HGH tables were *generated* by fitting the pseudo-atom to the
all-electron LDA atom: match the valence eigenvalues and the partial
charges q_nl(rcov) of the neutral atom (Goedecker-Teter-Hutter PRB 54,
1703 (1996) sec. II; the charge criterion enforces norm-conservation-like
behavior outside the core).  The reference reaches these tables through
PySCF's curated data files (``/root/reference/fftisdf.py:424``); offline,
a corrupted transcription (the embedded Ni q18 entry — see
``basis/data.py`` provenance notes) can only be repaired by re-running
that original fit.  ``basis/atom.py`` supplies both sides of it on one
radial grid, and its ``compare_pseudo`` discriminator then certifies the
result by exactly the standard that certifies a genuine table
(calibrated in ``tests/test_atom.py``).

Parameterization: the local coefficients ``cloc`` and the per-channel
projector strengths h_ii are free; h_12 is tied to h_22 by the HGH-1998
off-diagonal relation (``data.hgh_offdiag_deviation`` — the GTH-PADE
tables descend from the diagonal GTH-96 form, for which the relation is
exact), and the radii (rloc, r_l) are held at their transcribed values by
default (radii are printed with few digits and survive transcription far
more reliably than the 8-digit h matrix; ``vary_radii=True`` frees them).

Host-side scipy tool (setup/validation tier), like the rest of
``basis/atom.py``.  The port's copy of the JAX package's
``fftisdf_tpu/basis/fit.py``, equal to the bit.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares

from fftisdf_tpu_torch.basis.atom import (RadialGrid, pseudo_occupations,
                                          solve_atom)
from fftisdf_tpu_torch.basis.data import (ATOMIC_NUMBER, GTHPseudo,
                                          _HGH_H12_RATIO, element_symbol)

__all__ = ["covalent_radius", "atom_targets", "fit_gth"]

# Covalent radii (Cordero et al., Dalton Trans. 2008) in bohr — the
# charge-matching radius r_cov of the GTH fit.  Only the elements with
# embedded tables need entries; the exact value is not critical (both
# sides of the fit integrate to the same radius).
_RCOV_BOHR = {
    "H": 0.586, "He": 0.529, "C": 1.436, "N": 1.342, "O": 1.247,
    "F": 1.077, "Si": 2.098, "P": 2.022, "S": 1.984, "Cl": 1.927,
    "Ni": 2.343, "Cu": 2.494, "Zn": 2.306,
}


def covalent_radius(symbol: str) -> float:
    sym = element_symbol(symbol)
    if sym not in _RCOV_BOHR:
        raise KeyError(f"no covalent radius stored for {sym!r}")
    return _RCOV_BOHR[sym]


def _partial_charge(grid: RadialGrid, u: np.ndarray, rcov: float) -> float:
    """q = int_0^rcov u^2 dr (the GTH charge criterion per state)."""
    q = grid.cumint(u * u)
    return float(np.interp(rcov, grid.r, q))


def atom_targets(symbol: str, occ: dict, grid: RadialGrid,
                 rcov: float | None = None):
    """All-electron fit targets for the valence window ``occ``.

    Returns (labels, eps, q): per valence state (i, l), the AE LDA
    eigenvalue and the partial charge inside rcov.  Core states are
    skipped by index offset exactly as in ``compare_pseudo``.
    """
    sym = element_symbol(symbol)
    if rcov is None:
        rcov = covalent_radius(sym)
    ae = solve_atom(sym, grid=grid)
    if not ae.converged:
        raise RuntimeError(f"AE atom {sym} did not converge")
    labels, eps, q = [], [], []
    for l, occs in occ.items():
        ncore = len(ae.occ.get(l, [])) - len(occs)
        for i in range(len(occs)):
            labels.append((i, l))
            eps.append(float(ae.eps[l][ncore + i]))
            q.append(_partial_charge(grid, ae.u[l][ncore + i], rcov))
    return labels, np.array(eps), np.array(q)


def _pack(ps: GTHPseudo, vary_radii: bool) -> np.ndarray:
    x = list(ps.cloc)
    for l, rl, h in ps.projectors:
        h = np.asarray(h)
        if h.shape[0] > 2:
            raise NotImplementedError(">2 projectors per channel")
        x.extend(h[i, i] for i in range(h.shape[0]))
    if vary_radii:
        x.append(np.log(ps.rloc))
        x.extend(np.log(rl) for _, rl, _ in ps.projectors)
    return np.array(x, dtype=np.float64)


def _unpack(x: np.ndarray, template: GTHPseudo,
            vary_radii: bool) -> GTHPseudo:
    k = len(template.cloc)
    cloc = np.array(x[:k])
    pos = k
    nch = len(template.projectors)
    if vary_radii:
        nrad = 1 + nch
        rloc = float(np.exp(x[-nrad]))
        radii = [float(np.exp(v)) for v in x[-nrad + 1:]] if nch else []
    else:
        rloc = template.rloc
        radii = [rl for _, rl, _ in template.projectors]
    projs = []
    for (l, _, h0), rl in zip(template.projectors, radii):
        ni = np.asarray(h0).shape[0]
        h = np.zeros((ni, ni))
        for i in range(ni):
            h[i, i] = x[pos]; pos += 1
        if ni == 2:
            h[0, 1] = h[1, 0] = _HGH_H12_RATIO[l] * h[1, 1]
        projs.append((l, rl, h))
    return GTHPseudo(template.zion, rloc, cloc, projs)


def fit_gth(symbol: str, init: GTHPseudo, grid: RadialGrid | None = None,
            rcov: float | None = None, vary_radii: bool = False,
            w_eps: float = 1.0, w_q: float = 1.0,
            max_nfev: int = 400, verbose: bool = False):
    """Refit a GTH pseudopotential to the in-repo all-electron LDA atom.

    ``init`` supplies the structure (zion, channel count, projector
    counts) and the starting point; returns ``(GTHPseudo, info)`` with
    ``info['maxerr']`` the post-fit eigenvalue discriminator value (a
    successful fit lands in the genuine-table band, <~2e-3 Ha — gated in
    tests/test_atom.py by recovering a known-good table from a corrupted
    start).
    """
    sym = element_symbol(symbol)
    if grid is None:
        grid = RadialGrid(rmax=30.0, n=700)
    if rcov is None:
        rcov = covalent_radius(sym)
    occ = pseudo_occupations(sym, init)
    labels, eps_ae, q_ae = atom_targets(sym, occ, grid, rcov)

    warm = {"v": None}

    def pp_solve(ps: GTHPseudo):
        r = solve_atom(sym, pseudo=ps, occ=occ, grid=grid, tol=1e-11,
                       v_init=warm["v"])
        warm["v"] = r.v_eff
        return r

    neval = [0]

    def residuals(x):
        ps = _unpack(x, init, vary_radii)
        r = pp_solve(ps)
        eps = np.array([float(r.eps[l][i]) for i, l in labels])
        q = np.array([_partial_charge(grid, r.u[l][i], rcov)
                      for i, l in labels])
        neval[0] += 1
        out = np.concatenate([w_eps * (eps - eps_ae), w_q * (q - q_ae)])
        if verbose:
            print(f"  eval {neval[0]:3d}: |r| = {np.linalg.norm(out):.3e} "
                  f"maxeps {np.max(np.abs(eps - eps_ae)):.3e}", flush=True)
        return out

    x0 = _pack(init, vary_radii)
    # diff_step well above the SCF eigenvalue noise (~1e-8 Ha at
    # tol=1e-11): the default sqrt(eps) relative step makes the FD
    # Jacobian pure noise and LM stalls an order of magnitude short.
    sol = least_squares(residuals, x0, method="lm", max_nfev=max_nfev,
                        diff_step=1e-4, xtol=1e-12, ftol=1e-12)
    fitted = _unpack(sol.x, init, vary_radii)
    r = pp_solve(fitted)
    eps = np.array([float(r.eps[l][i]) for i, l in labels])
    q = np.array([_partial_charge(grid, r.u[l][i], rcov) for i, l in labels])
    info = dict(labels=labels, eps_ae=eps_ae, eps_pp=eps, q_ae=q_ae, q_pp=q,
                maxerr=float(np.max(np.abs(eps - eps_ae))),
                max_qerr=float(np.max(np.abs(q - q_ae))),
                cost=float(sol.cost), nfev=int(sol.nfev),
                status=int(sol.status), converged=r.converged)
    return fitted, info
