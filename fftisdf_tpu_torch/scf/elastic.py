"""Elastic constants from the analytic stress tensor (strain derivatives).

Counterpart of ``fftisdf_tpu/scf/elastic.py``.  The second-order elastic
tensor is assembled by central finite differences of the analytic strain
gradient (``scf.stress``, one reverse sweep per point) with the SCF
re-converged at every strained lattice:

    C_IJ = (1/V0) d2E / de_I de_J,    I, J Voigt, engineering shears.

Both derivatives must be taken with respect to the same strain coordinate
eps0 (A = a0 @ (1 + eps0)): one cell-gradient evaluator
(``make_cell_grad_fn``), built at the reference lattice, serves every
strained point at ``fn(mf_strained, eps=delta)`` with the density
re-converged on the strained cell, so no pullback of the strained
lattice's own gradient is needed and C_IJ is Maxwell-symmetric by
construction (the tests still cross-check it, since row I under strain J
and row J under strain I come from disjoint SCF solves).  The evaluator's
Lagrangian at each strained point must reproduce that SCF's energy, which
is asserted (it also certifies the frozen image lists still hold).
"""
from dataclasses import dataclass, field

import numpy as np

from fftisdf_tpu_torch.scf import stress as scf_stress
from fftisdf_tpu_torch.scf.optimize import _clone_mf

HA_PER_BOHR3_TO_GPA = 29421.02648438959

# Voigt index -> (i, j)
_VOIGT = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]


def voigt_strain(e):
    """(6,) engineering Voigt strain -> symmetric (3,3) strain matrix
    (shears e4..e6 are split half/half off-diagonal)."""
    e = np.asarray(e, dtype=np.float64)
    eps = np.zeros((3, 3))
    for v, (i, j) in enumerate(_VOIGT):
        if i == j:
            eps[i, i] = e[v]
        else:
            eps[i, j] = eps[j, i] = 0.5 * e[v]
    return eps


def stress_to_voigt(s):
    """Symmetric (3,3) stress -> (6,) Voigt vector (no shear factors)."""
    s = np.asarray(s)
    return np.array([s[i, j] for (i, j) in _VOIGT])


def strained_cell(cell, eps):
    """The cell deformed by A = a0 @ (1 + eps) with atoms co-deformed
    (fractional coordinates held fixed) and the FFT mesh UNCHANGED — the
    same functional scf.stress traces, so the analytic strain gradient at
    the strained cell is the exact derivative of the energy being FD'd."""
    f = np.eye(3) + np.asarray(eps, dtype=np.float64)
    atoms = [(sym, np.asarray(xyz, dtype=np.float64) @ f)
             for sym, xyz in cell.atom]
    return cell.copy(a=np.asarray(cell.a, dtype=np.float64) @ f,
                     atom=atoms,
                     mesh=np.asarray(cell.mesh, dtype=np.int64)).build()


def strained_kpts(cell, kpts, ncell):
    """``kpts`` of ``cell`` at the same fractional coordinates of the
    strained ``ncell``: the k-points deform with the cell, the convention
    ``scf.stress`` differentiates (the JAX package's elastic and EOS
    drivers keep the reference's Cartesian k-points, which agrees only at
    the Gamma point)."""
    return cell.get_scaled_kpts(np.asarray(kpts)) @ ncell.reciprocal_vectors()


@dataclass
class ElasticResult:
    c: np.ndarray            # (6,6) Voigt, Ha/bohr^3; NaN for skipped cols
    sigma0: np.ndarray       # (3,3) reference analytic stress, Ha/bohr^3
    e0: float                # reference total energy (Ha)
    step: float
    components: tuple
    # per computed component J: {"e_plus":..., "e_minus":...} total energies
    # of the strained SCFs (free second-derivative gate: (E+ - 2 E0 + E-)
    # / (step^2 V0) ~= C_JJ)
    energies: dict = field(default_factory=dict)

    @property
    def c_gpa(self):
        return self.c * HA_PER_BOHR3_TO_GPA

    def bulk_modulus_voigt(self):
        c = self.c
        return (c[0, 0] + c[1, 1] + c[2, 2]
                + 2.0 * (c[0, 1] + c[0, 2] + c[1, 2])) / 9.0

    def shear_modulus_voigt(self):
        c = self.c
        return ((c[0, 0] + c[1, 1] + c[2, 2])
                - (c[0, 1] + c[0, 2] + c[1, 2])
                + 3.0 * (c[3, 3] + c[4, 4] + c[5, 5])) / 15.0


def kernel(mf, step=2e-3, components=None, energy_tol=1e-7):
    """Elastic tensor C (6,6) Voigt, Ha/bohr^3, by central FD of the
    analytic strain gradient; ``mf`` must be converged.  Each strained SCF
    warm-starts from ``mf.dm``.  ``components`` restricts the strained
    Voigt directions (default all 6; skipped columns are NaN) — by Maxwell
    symmetry a restricted run still yields the full rows C[I, J] for
    computed J.  ``mf.xc`` / ``mf.hubbard`` / ``mf.exxdiv`` are honored
    (the differentiated functional is the one each strained density is stationary
    for); exact plane-wave two-electron energy."""
    assert getattr(mf, "dm", None) is not None and mf.converged
    if getattr(mf, "trunc", None) is not None:
        raise NotImplementedError(
            "elastic constants with a truncated Coulomb kernel")
    cell = mf.cell
    vol0 = float(cell.vol)
    comps = tuple(range(6)) if components is None else \
        tuple(int(j) for j in components)

    # ONE evaluator, built at the reference lattice, serves every strained
    # point at its own eps — shared executable, shared strain coordinate
    fn = scf_stress.make_cell_grad_fn(
        cell, mf.kpts, dtype=mf.dtype, exxdiv=getattr(mf, "exxdiv", None),
        xc=getattr(mf, "xc", None), hubbard=getattr(mf, "hubbard", None),
        device=mf.device)
    e0, g0, _ = fn(mf)
    sigma0 = 0.5 * (g0 + g0.T) / vol0

    def grad_at(delta_eps):
        ncell = strained_cell(cell, delta_eps)
        nmf = _clone_mf(mf, ncell, kpts=strained_kpts(cell, mf.kpts, ncell))
        nmf.kernel(dm0=mf.dm)
        if not nmf.converged:
            raise RuntimeError("SCF did not converge at a strained "
                               "lattice; reduce `step` or loosen conv_tol")
        val, geps, _ = fn(nmf, eps=delta_eps)
        if abs(val - nmf.e_tot) > energy_tol * max(1.0, abs(val)):
            raise RuntimeError(
                f"strain-Lagrangian value {val:.10f} != strained SCF "
                f"energy {nmf.e_tot:.10f}: strain left the frozen "
                "image-list validity region (reduce `step`)")
        return stress_to_voigt(0.5 * (geps + geps.T)) / vol0, float(val)

    c = np.full((6, 6), np.nan)
    energies = {}
    for j in comps:
        e = np.zeros(6)
        e[j] = step
        sp, ep = grad_at(voigt_strain(e))
        sm, em = grad_at(voigt_strain(-e))
        c[:, j] = (sp - sm) / (2.0 * step)
        energies[j] = {"e_plus": ep, "e_minus": em}
    return ElasticResult(c=c, sigma0=np.asarray(sigma0), e0=float(e0),
                         step=float(step), components=comps,
                         energies=energies)
