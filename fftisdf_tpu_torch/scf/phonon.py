"""Phonon dispersion from supercell force constants (frozen phonon).

Counterpart of ``fftisdf_tpu/scf/phonon.py``.  The harmonic force
constants Phi(0 kappa alpha; l kappa' beta) are measured by displacing the
home-cell atoms of an (n1 x n2 x n3) supercell and recording the analytic
force response on every supercell atom (central differences of the
reverse-mode gradient, ``scf.hessian``'s row-restricted kernel).  The
dynamical matrix at any wavevector q is the lattice Fourier transform

    D_{kappa alpha, kappa' beta}(q)
        = sum_l Phi(0 kappa alpha; l kappa' beta) e^{i q . R_l}
          / sqrt(m_kappa m_kappa'),

whose eigenvalues are omega^2(q).  Band folding (the supercell's Gamma
phonons are the primitive phonons at the commensurate q) and the acoustic
sum rule (three zero modes at q = 0) are its identities.  The drivers are
numpy on the host.
"""
from dataclasses import dataclass

import numpy as np

from fftisdf_tpu_torch.basis.data import ATOMIC_MASS, element_symbol
from fftisdf_tpu_torch.lattice.cell import cartesian_prod
from fftisdf_tpu_torch.scf import hessian as scf_hess
from fftisdf_tpu_torch.scf.hessian import AMU_TO_ME, HARTREE_TO_CM1
from fftisdf_tpu_torch.scf.optimize import _clone_mf


def make_supercell(cell, nrep):
    """Replicate ``cell`` into an (n1, n2, n3) supercell.

    Returns ``(scell, images)`` with ``images`` the (nl, 3) lattice
    translations in bohr, R = 0 FIRST, and the supercell atom list ordered
    image-major with the home cell first — supercell atom index
    ``l * natm_prim + kappa``.  This ordering is what force_constants
    assumes (it displaces the first ``natm_prim`` atoms only).
    """
    assert cell._built, "build() the primitive cell first"
    nrep = np.asarray(nrep, dtype=int)
    assert nrep.shape == (3,) and (nrep >= 1).all()
    ls = cartesian_prod([np.arange(int(n), dtype=float) for n in nrep])
    a = np.asarray(cell.a, dtype=np.float64)
    images = ls @ a                       # (nl, 3) bohr; ls[0] == (0,0,0)
    nl = len(images)
    atoms = [(sym, np.asarray(xyz, dtype=np.float64) + r)
             for r in images for sym, xyz in cell.atom]
    scell = cell.copy(
        a=a * nrep[:, None],
        atom=atoms,
        mesh=np.asarray(cell.mesh, dtype=np.int64) * nrep,
        charge=cell.charge * nl,
        spin=cell.spin * nl,
    ).build()
    return scell, images


def atom_masses_me(cell, masses=None):
    """Per-atom masses in electron-mass units (amu overridable)."""
    if masses is None:
        masses = [ATOMIC_MASS[element_symbol(s)]
                  for s in cell.atom_symbols()]
    return np.asarray(masses, dtype=np.float64) * AMU_TO_ME


def enforce_asr(fc):
    """Acoustic sum rule: shift the self term so that
    ``sum_{l kappa'} Phi(0 kappa alpha; l kappa' beta) = 0`` exactly.

    On the FFT mesh the raw constants violate this by the egg-box force
    (a rigid translation of the whole crystal relative to the fixed grid
    costs energy at finite mesh); the ASR restores the continuum symmetry,
    which is the correct physical limit."""
    fc = np.array(fc, copy=True)
    resid = fc.sum(axis=(2, 3))           # (nprim, 3, 3)
    for k in range(fc.shape[0]):
        fc[k, :, 0, k, :] -= resid[k]
    return fc


@dataclass
class PhononResult:
    fc: np.ndarray          # (nprim, 3, nl, nprim, 3) force constants, Ha/bohr^2
    images: np.ndarray      # (nl, 3) supercell translations, bohr
    cell: object            # primitive cell
    nrep: tuple
    masses_me: np.ndarray   # (nprim,)
    mf_sc: object = None    # converged supercell SCF (for reuse/inspection)
    e_sc: float = 0.0       # supercell total energy (Ha)

    def dynamical_matrix(self, q):
        return dynamical_matrix(self.fc, self.masses_me, self.images, q)

    def frequencies(self, qpts):
        return frequencies(self.fc, self.masses_me, self.images, qpts)

    def thermodynamics(self, qmesh, temperature):
        return thermodynamics(self.fc, self.masses_me, self.images,
                              self.cell, qmesh, temperature)


def dynamical_matrix(fc, masses_me, images, q):
    """Hermitized dynamical matrix D(q), shape (d*nprim, d*nprim), in
    Ha / (bohr^2 m_e); eigenvalues are omega^2 in atomic units.  ``d`` is
    read from ``fc`` (normally 3; a Cartesian sub-slice of the constants,
    e.g. the longitudinal fc[:, 2:, :, :, 2:] of a chain, analyzes that
    subspace alone)."""
    nprim, ndim = fc.shape[0], fc.shape[1]
    ph = np.exp(1j * images @ np.asarray(q, dtype=np.float64))   # (nl,)
    d = np.einsum("l,kalmb->kamb", ph, fc)
    minv = 1.0 / np.sqrt(masses_me)
    d = d * minv[:, None, None, None] * minv[None, None, :, None]
    d = d.reshape(ndim * nprim, ndim * nprim)
    # minimal supercells fold the (exactly hermitian) infinite-lattice sum
    # onto a finite image set; the skew part is the truncation artifact
    return 0.5 * (d + d.conj().T)


def frequencies(fc, masses_me, images, qpts):
    """Harmonic wavenumbers (nq, 3*nprim) in cm^-1, ascending per q;
    negative values encode imaginary (unstable) modes."""
    qpts = np.atleast_2d(np.asarray(qpts, dtype=np.float64))
    out = []
    for q in qpts:
        ev = np.linalg.eigvalsh(dynamical_matrix(fc, masses_me, images, q))
        out.append(np.sign(ev) * np.sqrt(np.abs(ev)) * HARTREE_TO_CM1)
    return np.asarray(out)


KB_HA = 3.166811563e-6   # Boltzmann constant, Ha / K


def thermodynamics(fc, masses_me, images, cell, qmesh, temperature,
                   imag_tol=-5.0, freq_floor_cm=1.0):
    """Harmonic vibrational thermodynamics per primitive cell, from the
    phonon spectrum Fourier-interpolated on a uniform ``qmesh`` BZ sample.

    Returns a dict with ``zpe``, ``f_vib`` (ZPE + thermal free energy),
    ``u_vib``, ``s_vib``, ``cv`` — all in Ha (entropy Ha/K) — the
    quasi-harmonic ingredients (E(V) + f_vib(V, T) minimization).

    Modes with wavenumber below ``imag_tol`` cm^-1 raise (a genuinely
    unstable structure has no harmonic free energy); the
    [imag_tol, freq_floor_cm) band — acoustic Gamma modes, ASR residue and
    interpolation noise, which force-constant noise leaves at EITHER sign
    near zero — is excluded entirely.  The positive floor matters: a
    spurious +1e-3 cm^-1 residue mode contributes ~0 ZPE but
    kT ln(1 - e^{-x}) ~ kT ln x ~ -0.1 Ha of classical-limit entropy at
    room temperature, an O(1) free-energy artifact whose presence flips
    with the noise sign per geometry (observed to corrupt E(V)+F_vib QHA
    scans; same floor semantics as eos.gruneisen).
    """
    w_cm = frequencies(fc, masses_me, images,
                       cell.get_kpts([int(m) for m in qmesh]))
    if w_cm.min() < imag_tol:
        raise ValueError(
            f"imaginary mode {w_cm.min():.2f} cm^-1 below tolerance "
            f"{imag_tol}: unstable structure, no harmonic free energy")
    w = np.clip(w_cm, 0.0, None) / HARTREE_TO_CM1      # Ha, (nq, nmode)
    nq = w.shape[0]
    pos = w[w > float(freq_floor_cm) / HARTREE_TO_CM1]
    zpe = 0.5 * pos.sum() / nq
    t = float(temperature)
    out = {"zpe": zpe, "f_vib": zpe, "u_vib": zpe, "s_vib": 0.0, "cv": 0.0,
           "temperature": t, "nq": nq}
    if t > 0.0:
        x = pos / (KB_HA * t)
        out["f_vib"] = zpe + KB_HA * t * np.log1p(-np.exp(-x)).sum() / nq
        out["u_vib"] = zpe + (pos / np.expm1(x)).sum() / nq
        out["s_vib"] = (out["u_vib"] - out["f_vib"]) / t
        ex = np.exp(-x)   # exp(x) overflows for stiff modes at low T
        out["cv"] = (KB_HA * (x * x * ex / (1.0 - ex) ** 2)).sum() / nq
    return out


def force_constants(mf_sc, nprim, nl, step=1e-3, two_electron="pw", df=None):
    """Force constants from a CONVERGED supercell SCF whose atom ordering
    follows make_supercell (home cell first).  Displaces the 3*nprim
    home-cell coordinates, forces on all 3*nprim*nl supercell coordinates.
    Returns (nprim, 3, nl, nprim, 3)."""
    assert len(mf_sc.cell.atom) == nprim * nl
    rows, _ = scf_hess.kernel(mf_sc, step=step, two_electron=two_electron,
                              df=df, symmetrize=False,
                              rows=range(3 * nprim))
    return np.asarray(rows).reshape(nprim, 3, nl, nprim, 3)


def kernel(mf, nrep, step=1e-3, two_electron="pw", df=None, asr=True,
           masses=None):
    """Frozen-phonon force constants for the primitive-cell SCF template
    ``mf`` on an ``nrep`` supercell (SCF re-converged there from scratch at
    the supercell Gamma point; ``mf`` supplies every SCF knob and need not
    be converged itself).

    ``two_electron='isdf'`` differentiates the frozen-point ISDF
    approximant: pass ``df`` built on the SUPERCELL.  Returns a
    PhononResult; ``result.frequencies(qpts)`` serves any q, exact at the
    commensurate set ``mf.cell.get_kpts(nrep)`` (band folding) and Fourier
    interpolation elsewhere."""
    cell = mf.cell
    scell, images = make_supercell(cell, nrep)
    mf_sc = _clone_mf(mf, scell, kpts=scell.get_kpts([1, 1, 1]))
    mf_sc.kernel()
    if not mf_sc.converged:
        raise RuntimeError("supercell SCF did not converge; loosen "
                           "conv_tol or enable smearing on the template")
    fc = force_constants(mf_sc, cell.natm, len(images), step=step,
                         two_electron=two_electron, df=df)
    if asr:
        fc = enforce_asr(fc)
    return PhononResult(fc=fc, images=images, cell=cell,
                        nrep=tuple(int(n) for n in np.asarray(nrep)),
                        masses_me=atom_masses_me(cell, masses),
                        mf_sc=mf_sc, e_sc=float(mf_sc.e_tot))
