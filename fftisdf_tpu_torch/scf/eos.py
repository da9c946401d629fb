"""Equation of state: E(V) volume scans and Birch-Murnaghan fits.

Counterpart of ``fftisdf_tpu/scf/eos.py``.  ``kernel`` re-converges the
SCF on isotropically scaled cells (A = s a0, atoms co-deformed at fixed
fractions, FFT mesh unchanged: the functional ``scf.stress`` differentiates)
and measures dE/dV analytically at every point through one cell-gradient
evaluator built at the reference lattice and evaluated at eps = (s-1) I.
The Birch-Murnaghan fit then has a cross-check: its -dE/dV must reproduce
the analytic pressures at the scan points.

The third-order Birch-Murnaghan energy is a cubic polynomial in
x = V^(-2/3),

    E(V) = c0 + c1 x + c2 x^2 + c3 x^3,

so the fit is linear least squares, and (E0, V0, B0, B') follow in closed
form: dE/dx = 0 is a quadratic in x (the physical root has d2E/dV2 > 0),
B0 = V d2E/dV2 and B' = -d(ln B)/d(ln V) - 1 at V0 by the chain rule
through x(V).  With ``scf.phonon.thermodynamics`` this is the
quasi-harmonic ingredient set (:func:`qha`, :func:`qha_kernel`).
"""
from dataclasses import dataclass, field

import numpy as np

from fftisdf_tpu_torch.scf import phonon as scf_phonon
from fftisdf_tpu_torch.scf import stress as scf_stress
from fftisdf_tpu_torch.scf.elastic import (HA_PER_BOHR3_TO_GPA,
                                           strained_cell, strained_kpts)
from fftisdf_tpu_torch.scf.hessian import HARTREE_TO_CM1
from fftisdf_tpu_torch.scf.optimize import _clone_mf
from fftisdf_tpu_torch.scf.phonon import KB_HA


def birch_murnaghan(v, e0, v0, b0, bp):
    """Third-order Birch-Murnaghan energy at volume(s) ``v``."""
    eta = (np.asarray(v, dtype=np.float64) / v0) ** (-2.0 / 3.0)
    return e0 + 9.0 * v0 * b0 / 16.0 * (
        (eta - 1.0) ** 3 * bp + (eta - 1.0) ** 2 * (6.0 - 4.0 * eta))


def _poly_to_params(c):
    """(E0, V0, B0, B') from E = c0 + c1 x + c2 x^2 + c3 x^3, x = V^(-2/3).

    Returns NaNs when no physical stationary point (x > 0 with
    d2E/dV2 > 0) lies on the fitted branch."""
    c0, c1, c2, c3 = [float(x) for x in c]
    # dE/dx = c1 + 2 c2 x + 3 c3 x^2 = 0
    disc = 4.0 * c2 * c2 - 12.0 * c3 * c1
    nan4 = (np.nan,) * 4
    if disc < 0.0:
        return nan4
    roots = []
    if abs(c3) > 1e-300:
        sq = np.sqrt(disc)
        roots = [(-2.0 * c2 + s * sq) / (6.0 * c3) for s in (+1.0, -1.0)]
    elif abs(c2) > 1e-300:
        roots = [-c1 / (2.0 * c2)]
    best = None
    for x in roots:
        if x <= 0.0:
            continue
        v = x ** (-1.5)
        # B = V d2E/dV2; with dE/dx = 0 at x0:
        #   d2E/dV2 = (dx/dV)^2 d2E/dx2,  dx/dV = -(2/3) x / V
        d2x = 2.0 * c2 + 6.0 * c3 * x
        b = v * (2.0 / 3.0 * x / v) ** 2 * d2x
        if b > 0.0 and (best is None or b > 0.0):
            e = c0 + x * (c1 + x * (c2 + x * c3))
            # B' = dB/dP at V0.  With E_x = 0 there:
            #   B0 = (4/9) E_xx x^2 / V,
            #   dB/dV = -(16/9) E_xx x^2/V^2 - (8/27) E_xxx x^3/V^2
            #   (from x' = -(2/3) x/V, x'' = (10/9) x/V^2), hence
            #   B' = -(dB/dV) V / B = 4 + (2/3) E_xxx x / E_xx.
            bp = 4.0 + (2.0 / 3.0) * (6.0 * c3) * x / d2x
            best = (e, v, b, bp)
    return best if best is not None else nan4


def fit_birch_murnaghan(volumes, energies):
    """Linear BM3 fit.  Returns dict with e0, v0, b0 (Ha/bohr^3), b0_gpa,
    bp, the raw cubic coefficients ``poly`` (in x = V^(-2/3)), and the
    rms fit residual."""
    v = np.asarray(volumes, dtype=np.float64)
    e = np.asarray(energies, dtype=np.float64)
    assert v.size >= 4, "BM3 has 4 parameters"
    x = v ** (-2.0 / 3.0)
    basis = np.stack([np.ones_like(x), x, x * x, x ** 3], axis=1)
    c, *_ = np.linalg.lstsq(basis, e, rcond=None)
    resid = basis @ c - e
    e0, v0, b0, bp = _poly_to_params(c)
    return {"e0": e0, "v0": v0, "b0": b0,
            "b0_gpa": b0 * HA_PER_BOHR3_TO_GPA, "bp": bp,
            "poly": np.asarray(c),
            "rms": float(np.sqrt(np.mean(resid ** 2)))}


def bm_pressure(poly, v):
    """Analytic -dE/dV of the fitted cubic at volume(s) ``v``."""
    v = np.asarray(v, dtype=np.float64)
    x = v ** (-2.0 / 3.0)
    dedx = poly[1] + 2.0 * poly[2] * x + 3.0 * poly[3] * x * x
    return -dedx * (-(2.0 / 3.0) * x / v)


@dataclass
class EOSResult:
    scales: np.ndarray       # linear scale factors s (V = s^3 V0_ref)
    volumes: np.ndarray      # bohr^3
    energies: np.ndarray     # Ha (SCF total energies at each volume)
    pressures: np.ndarray    # Ha/bohr^3, ANALYTIC -dE/dV at each point
    fit: dict = field(default_factory=dict)   # fit_birch_murnaghan output

    @property
    def pressures_gpa(self):
        return self.pressures * HA_PER_BOHR3_TO_GPA


def qha(volumes, e_el, f_vib, temperatures):
    """Quasi-harmonic approximation on a volume grid: minimize
    F(V; T) = E_el(V) + F_vib(V; T) per temperature via the BM3 fit.

    ``e_el`` (nv,) are the SCF energies of an E(V) scan (EOSResult.energies)
    and ``f_vib`` (nt, nv) the harmonic vibrational free energies at the
    same volumes (scf.phonon.thermodynamics per scan point, 'f_vib' entry).

    Returns dict of (nt,) arrays: ``v0`` equilibrium volume, ``b0`` /
    ``b0_gpa`` isothermal bulk modulus, ``f0`` free energy at the minimum,
    and ``alpha_v`` the volumetric thermal-expansion coefficient
    d ln V0 / dT by central differences over ``temperatures`` (one-sided
    at the ends; NaN for a single temperature)."""
    volumes = np.asarray(volumes, dtype=np.float64)
    e_el = np.asarray(e_el, dtype=np.float64)
    f_vib = np.atleast_2d(np.asarray(f_vib, dtype=np.float64))
    ts = np.asarray(temperatures, dtype=np.float64)
    assert f_vib.shape == (ts.size, volumes.size)
    v0 = np.empty(ts.size)
    b0 = np.empty(ts.size)
    f0 = np.empty(ts.size)
    for i in range(ts.size):
        fit = fit_birch_murnaghan(volumes, e_el + f_vib[i])
        v0[i], b0[i], f0[i] = fit["v0"], fit["b0"], fit["e0"]
    alpha = np.full(ts.size, np.nan)
    if ts.size >= 2:
        lnv = np.log(v0)
        alpha[1:-1] = (lnv[2:] - lnv[:-2]) / (ts[2:] - ts[:-2])
        alpha[0] = (lnv[1] - lnv[0]) / (ts[1] - ts[0])
        alpha[-1] = (lnv[-1] - lnv[-2]) / (ts[-1] - ts[-2])
    return {"temperatures": ts, "v0": v0, "b0": b0,
            "b0_gpa": b0 * HA_PER_BOHR3_TO_GPA, "f0": f0,
            "alpha_v": alpha}


def gruneisen(volumes, freqs_cm, temperature=None, b0=None, v0=None,
              freq_floor_cm=1.0):
    """Mode-Grueneisen parameters from a volume scan of the phonon
    spectrum: ``gamma_i = -d ln w_i / d ln V``, by linear least squares of
    ln w_i against ln V over the scan (EXACT for power-law w(V) — the
    quasi-harmonic ansatz — for any volume spacing).

    ``freqs_cm``: (nv, nq, nmode) or (nv, nmode) frequencies in cm^-1 at
    each scan volume (``scf.phonon.frequencies`` on each scaled cell's
    force constants; mode ordering must be consistent across the scan,
    which sorted dynamical-matrix eigenvalues give away from band
    crossings).  Modes below ``freq_floor_cm`` anywhere in the scan
    (acoustic Gamma modes and ASR/FD residue, which the force-constant
    noise can leave at either sign near zero) get gamma = 0 and zero
    weight.

    With ``temperature`` (K), ``b0`` (Ha/bohr^3) and ``v0`` (bohr^3, the
    equilibrium volume the relation is evaluated at — defaults to the scan
    midpoint), also returns the Grueneisen thermal expansion

        alpha_V(T) = sum_{q,i} gamma_{q,i} c_{q,i}(T) / (B0 V0 nq),

    the closed-form QHA limit that ``qha`` obtains by explicit F(V, T)
    minimization — the two must agree near equilibrium (gated in
    tests/test_eos.py), and per-mode c_{q,i} is the Einstein heat capacity
    of the mid-scan frequency.
    """
    volumes = np.asarray(volumes, dtype=np.float64)
    w = np.asarray(freqs_cm, dtype=np.float64)
    assert w.shape[0] == volumes.size and volumes.size >= 2
    shape = w.shape[1:]
    nq = shape[0] if w.ndim == 3 else 1
    w = w.reshape(volumes.size, -1)
    ok = (w > float(freq_floor_cm)).all(axis=0)
    lnv = np.log(volumes) - np.log(volumes).mean()
    denom = (lnv * lnv).sum()
    gamma = np.zeros(w.shape[1])
    lnw = np.log(np.where(ok[None, :], w, 1.0))
    gamma[ok] = -(lnv @ (lnw - lnw.mean(axis=0)))[ok] / denom
    out = {"gamma": gamma.reshape(shape), "mask": ok.reshape(shape)}
    iv = int(np.argmin(np.abs(volumes - np.median(volumes))))
    if temperature is not None:
        out.update(_gruneisen_thermal(
            gamma, w[iv], ok, nq, float(temperature), b0=b0,
            v0=float(volumes[iv]) if v0 is None else float(v0),
            shape=shape))
    return out


def _gruneisen_thermal(gamma, w_mid_cm, ok, nq, t, b0=None, v0=None,
                       shape=None):
    """Per-temperature part of :func:`gruneisen` (Einstein mode heat
    capacities of the mid-scan frequencies, cv-weighted mean gamma and the
    closed-form alpha_V) — factored out so a caller scanning temperatures
    fits the gammas ONCE (qha_kernel)."""
    cv = np.zeros(gamma.size)
    if t > 0.0:
        x = w_mid_cm[ok] / HARTREE_TO_CM1 / (KB_HA * t)
        ex = np.exp(-x)   # exp(x) overflows for stiff modes at low T
        cv[ok] = KB_HA * x * x * ex / (1.0 - ex) ** 2
    out = {"cv_modes": cv.reshape(shape) if shape is not None else cv}
    wsum = cv.sum()
    out["gamma_mean"] = (float((gamma * cv).sum() / wsum) if wsum > 0.0
                         else float(gamma[ok].mean()) if ok.any()
                         else 0.0)
    if b0 is not None:
        out["alpha_v"] = float((gamma * cv).sum() / (float(b0) * float(v0)
                                                     * nq))
    return out


def qha_kernel(mf, temperatures, scales=None, nrep=(1, 1, 1), qmesh=None,
               step=1e-3, masses=None, energy_tol=1e-7):
    """Full quasi-harmonic pipeline on a converged primitive-cell SCF:
    E(V) scan (``kernel``), frozen-phonon force constants and harmonic
    free energies per scan volume (``scf.phonon.kernel`` on each scaled
    cell), F(V, T) minimization (``qha``), and mode-Grueneisen analysis
    (``gruneisen``) over the same scan — first-principles thermal
    expansion in one call.

    ``nrep`` is the phonon supercell and ``qmesh`` the BZ sample for the
    vibrational free energy (defaults to ``nrep``, the exactly-folded
    set).  At least 4 scan points are needed for the per-temperature BM3
    fit.  Returns the ``qha`` dict extended with ``eos`` (EOSResult),
    ``freqs_cm`` (nv, nq, nmode) phonon scans, ``gamma`` / ``gamma_mask``
    mode-Grueneisen parameters, and ``alpha_v_gruneisen`` (nt,) — the
    closed-form Grueneisen thermal expansion, an internal cross-check on
    the FD ``alpha_v`` from the explicit minimization."""
    res = kernel(mf, scales=scales, energy_tol=energy_tol)
    if res.scales.size < 4:
        raise ValueError("qha_kernel needs >= 4 scan points for the "
                         "per-temperature BM3 fit")
    ts = np.atleast_1d(np.asarray(temperatures, dtype=np.float64))
    qmesh = tuple(int(n) for n in (nrep if qmesh is None else qmesh))
    cell = mf.cell
    fvib = np.empty((ts.size, res.scales.size))
    freqs = []
    for j, s in enumerate(res.scales):
        tmpl = mf if abs(float(s) - 1.0) < 1e-14 else _clone_mf(
            mf, strained_cell(cell, (float(s) - 1.0) * np.eye(3)))
        ph = scf_phonon.kernel(tmpl, nrep, step=step, masses=masses)
        freqs.append(ph.frequencies(ph.cell.get_kpts(list(qmesh))))
        for i, t in enumerate(ts):
            fvib[i, j] = ph.thermodynamics(qmesh, float(t))["f_vib"]
    freqs = np.asarray(freqs)

    out = qha(res.volumes, res.energies, fvib, ts)
    out["eos"] = res
    out["f_vib"] = fvib
    out["freqs_cm"] = freqs
    g0 = gruneisen(res.volumes, freqs)
    out["gamma"], out["gamma_mask"] = g0["gamma"], g0["mask"]
    # per-T alpha reuses the ONE log-log gamma fit above (only the Einstein
    # cv weights depend on T)
    gam = g0["gamma"].reshape(-1)
    ok = g0["mask"].reshape(-1)
    nq = freqs.shape[1]
    iv = int(np.argmin(np.abs(res.volumes - np.median(res.volumes))))
    w_mid = freqs[iv].reshape(-1)
    ag = np.full(ts.size, np.nan)
    for i, t in enumerate(ts):
        if t > 0.0:
            ag[i] = _gruneisen_thermal(gam, w_mid, ok, nq, float(t),
                                       b0=out["b0"][i],
                                       v0=out["v0"][i])["alpha_v"]
    out["alpha_v_gruneisen"] = ag
    return out


def kernel(mf, scales=None, energy_tol=1e-7):
    """E(V) scan + analytic pressures + BM3 fit for a converged ``mf``.

    ``scales`` are LINEAR lattice scale factors (default 5 points over
    +/- 3%); each point re-converges the SCF warm-started from ``mf.dm``
    on the scaled cell and evaluates dE/dV through the one
    reference-lattice strain evaluator at eps = (s-1) I.  ``mf.xc`` /
    ``mf.hubbard`` / ``mf.exxdiv`` are honored."""
    assert getattr(mf, "dm", None) is not None and mf.converged
    if getattr(mf, "trunc", None) is not None:
        raise NotImplementedError("EOS with a truncated Coulomb kernel")
    cell = mf.cell
    vol0 = float(cell.vol)
    scales = np.linspace(0.97, 1.03, 5) if scales is None \
        else np.asarray(scales, dtype=np.float64)

    fn = scf_stress.make_cell_grad_fn(
        cell, mf.kpts, dtype=mf.dtype, exxdiv=getattr(mf, "exxdiv", None),
        xc=getattr(mf, "xc", None), hubbard=getattr(mf, "hubbard", None),
        device=mf.device)

    vols, es, ps = [], [], []
    for s in scales:
        eps = (float(s) - 1.0) * np.eye(3)
        if abs(s - 1.0) < 1e-14:
            nmf, val = mf, float(mf.e_tot)
        else:
            ncell = strained_cell(cell, eps)
            nmf = _clone_mf(mf, ncell,
                            kpts=strained_kpts(cell, mf.kpts, ncell))
            nmf.kernel(dm0=mf.dm)
            if not nmf.converged:
                raise RuntimeError(
                    f"SCF did not converge at scale {s}; narrow `scales` "
                    "or loosen conv_tol")
        val, geps, _ = fn(nmf, eps=eps)
        if abs(val - nmf.e_tot) > energy_tol * max(1.0, abs(val)):
            raise RuntimeError(
                f"strain-Lagrangian value {val:.10f} != scaled SCF energy "
                f"{nmf.e_tot:.10f} at scale {s}: outside the frozen "
                "image-list validity region (narrow `scales`)")
        # dE/dV: E(s) with V = s^3 V0; dE/ds = tr(dE/deps0) (isotropic
        # direction), dV/ds = 3 s^2 V0
        dedv = float(np.trace(geps)) / (3.0 * float(s) ** 2 * vol0)
        vols.append(float(s) ** 3 * vol0)
        es.append(float(val))
        ps.append(-dedv)
    vols = np.asarray(vols)
    es = np.asarray(es)
    return EOSResult(scales=scales, volumes=vols, energies=es,
                     pressures=np.asarray(ps),
                     fit=fit_birch_murnaghan(vols, es))
