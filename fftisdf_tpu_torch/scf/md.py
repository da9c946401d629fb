"""Born-Oppenheimer molecular dynamics on the analytic nuclear forces.

Counterpart of ``fftisdf_tpu/scf/md.py``.  Velocity-Verlet NVE
integration, with optional canonical (NVT) sampling by a BAOAB Langevin
integrator or Bussi-Donadio-Parrinello stochastic velocity rescaling
(CSVR).  Every step re-converges the SCF at the new geometry (warm-started
from the previous density) and takes the force from one reverse-mode sweep
(``scf.grad`` through :class:`scf.optimize.BOForceField`), so NVE
trajectories conserve the total energy to the Verlet O(dt^2) floor.

:func:`npt_kernel` adds constant-pressure dynamics: an isotropic Berendsen
barostat driven by the analytic stress (forces and stress from one reverse
sweep through the anchored cell Lagrangian of ``scf.stress``).

Units: positions bohr, energies hartree, time fs at the API surface
(atomic time units inside), temperature kelvin, masses from the standard
atomic weights (``basis.data.ATOMIC_MASS``).  The centre-of-mass
acceleration (the egg-box artifact's net force) is projected out of every
force.  The integrators are numpy on the host; the SCFs and gradient
sweeps run on the device of the starting SCF.
"""
from dataclasses import dataclass, field

import numpy as np

from fftisdf_tpu_torch.basis.data import ATOMIC_MASS, element_symbol
from fftisdf_tpu_torch.scf.optimize import BOForceField, _clone_mf, _logger

KB_HARTREE = 3.166811563e-6        # Boltzmann constant (Ha/K)
AU_TIME_FS = 2.4188843265857e-2    # one atomic time unit in fs
AMU_TO_ME = 1822.888486209         # electron masses per amu
GPA_PER_AU = 29421.02648438959     # 1 Ha/bohr^3 in GPa


@dataclass
class MDResult:
    positions: np.ndarray          # (natm, 3) bohr, final geometry
    velocities: np.ndarray         # (natm, 3) bohr / a.u. time
    mf: object                     # converged SCF at the final geometry
    # per recorded step: dict(t_fs, positions, e_pot, e_kin, e_tot, temp_k)
    trajectory: list = field(default_factory=list)
    nsteps: int = 0

    @property
    def energies(self):
        """(nrec,) total energies e_pot + e_kin along the trajectory."""
        return np.array([rec["e_tot"] for rec in self.trajectory])

    @property
    def temperatures(self):
        return np.array([rec["temp_k"] for rec in self.trajectory])


def atom_masses(cell, masses=None):
    """(natm,) masses in electron-mass units (atomic units), from the
    standard atomic weights unless overridden by ``masses`` (amu)."""
    if masses is None:
        masses = [ATOMIC_MASS[element_symbol(s)]
                  for s in cell.atom_symbols()]
    return np.asarray(masses, dtype=np.float64) * AMU_TO_ME


def maxwell_boltzmann(masses_me, temperature, rng, remove_com=True):
    """(natm, 3) velocities sampled at ``temperature`` K, COM removed.

    After COM removal the kinetic energy is rescaled back onto the
    ``3*natm - 3`` internal degrees of freedom so <E_kin> matches the
    equipartition value for the projected system."""
    natm = len(masses_me)
    v = rng.standard_normal((natm, 3)) * np.sqrt(
        KB_HARTREE * temperature / masses_me)[:, None]
    if remove_com and natm > 1:
        p = (masses_me[:, None] * v).sum(axis=0)
        v -= p / masses_me.sum()
        ndof = 3 * natm - 3
        ek = 0.5 * float((masses_me[:, None] * v * v).sum())
        target = 0.5 * ndof * KB_HARTREE * temperature
        if ek > 0:
            v *= np.sqrt(target / ek)
    return v


def _project_net_force(force, masses_me):
    """Remove the COM acceleration: F_i -= m_i * (sum_j F_j) / M_tot."""
    net = force.sum(axis=0)
    return force - masses_me[:, None] * (net / masses_me.sum())


def _csvr_factor(e_kin, e_kin_target, ndof, c, rng):
    """Bussi-Donadio-Parrinello stochastic velocity-rescaling factor
    (J. Chem. Phys. 126, 014101 (2007), eq. A7): alpha^2 for one step with
    decay factor c = exp(-dt/tau).  Samples the exact canonical kinetic-
    energy distribution over the ``ndof`` internal degrees of freedom."""
    if e_kin <= 0.0:
        # no kinetic energy to rescale: inject the full target via a
        # one-step draw (degenerate start; next steps proceed normally)
        return None
    r1 = rng.standard_normal()
    s = rng.chisquare(ndof - 1) if ndof > 1 else 0.0
    ratio = e_kin_target / (ndof * e_kin)
    a2 = (c + (1.0 - c) * ratio * (r1 * r1 + s)
          + 2.0 * r1 * np.sqrt(c * (1.0 - c) * ratio))
    return np.sqrt(max(a2, 0.0))


def kernel(mf, dt_fs=0.5, nsteps=20, temperature=None, thermostat=None,
           friction_fs=100.0, tau_fs=100.0, velocities0=None, seed=0,
           two_electron="pw", isdf_kwargs=None, callback=None,
           log_every=1):
    """Run ``nsteps`` of Born-Oppenheimer MD from ``mf.cell``'s geometry.

    ``thermostat``: None (NVE velocity Verlet), ``'langevin'`` (BAOAB with
    friction time ``friction_fs``), or ``'csvr'`` (velocity Verlet + Bussi
    stochastic rescaling with coupling time ``tau_fs``); both NVT modes
    require ``temperature``.  Initial velocities: ``velocities0`` (natm, 3)
    in bohr per a.u. time, else Maxwell-Boltzmann at ``temperature`` (zero
    if no temperature either).  ``two_electron``/``isdf_kwargs`` select the
    force backend exactly as in :func:`scf.optimize.kernel`.  Returns an
    :class:`MDResult`; ``callback(step, positions, velocities, e_pot)`` runs
    after each recorded step.
    """
    log = _logger(mf)
    if thermostat not in (None, "nve", "langevin", "csvr"):
        raise ValueError(f"unknown thermostat {thermostat!r}")
    if thermostat == "nve":
        thermostat = None
    if thermostat is not None and temperature is None:
        raise ValueError(f"thermostat {thermostat!r} requires a temperature")

    cell = mf.cell
    ff = BOForceField(mf, two_electron=two_electron,
                      isdf_kwargs=isdf_kwargs)
    m = atom_masses(cell)                       # (natm,) electron masses
    natm = len(m)
    ndof = max(3 * natm - 3, 1)                 # COM projected out
    dt = dt_fs / AU_TIME_FS                     # atomic time units
    rng = np.random.default_rng(seed)

    x = np.asarray(cell.atom_coords(), dtype=np.float64)
    if velocities0 is not None:
        v = np.asarray(velocities0, dtype=np.float64).copy()
    elif temperature is not None:
        v = maxwell_boltzmann(m, temperature, rng)
    else:
        v = np.zeros_like(x)

    def forces(positions, dm0):
        mf_c, e, g = ff(positions, dm0)
        return mf_c, e, _project_net_force(-g, m)

    # seed from the caller's mf if already converged at the start geometry
    usable = (getattr(mf, "dm", None) is not None and mf.converged
              and (two_electron != "isdf"
                   or getattr(mf.with_df, "wq", None) is not None))
    if usable:
        e_pot, g = ff.eval_converged(mf)
        cur_mf, f = mf, _project_net_force(-g, m)
    else:
        cur_mf, e_pot, f = forces(x, None)

    def ekin(v):
        return 0.5 * float((m[:, None] * v * v).sum())

    def record(step, e_pot, v):
        ek = ekin(v)
        rec = dict(t_fs=step * dt_fs, positions=x.copy(), e_pot=e_pot,
                   e_kin=ek, e_tot=e_pot + ek,
                   temp_k=2.0 * ek / (ndof * KB_HARTREE))
        traj.append(rec)
        if step % log_every == 0:
            log.info("md step %4d  t=%7.2f fs  E_pot=%.10f  E_tot=%.10f  "
                     "T=%7.1f K", step, rec["t_fs"], e_pot, rec["e_tot"],
                     rec["temp_k"])
        if callback is not None:
            callback(step, x, v, e_pot)

    traj = []
    record(0, e_pot, v)

    if thermostat == "langevin":
        gamma = 1.0 / (friction_fs / AU_TIME_FS)      # 1 / a.u. time
        c1 = np.exp(-gamma * dt)
        c2 = np.sqrt((1.0 - c1 * c1) * KB_HARTREE * temperature / m)[:, None]
    e_kin_target = (0.5 * ndof * KB_HARTREE * temperature
                    if temperature is not None else None)

    for step in range(1, nsteps + 1):
        if thermostat == "langevin":
            # BAOAB: B (half kick) A (half drift) O (exact OU) A B
            v = v + 0.5 * dt * f / m[:, None]
            x = x + 0.5 * dt * v
            v = c1 * v + c2 * rng.standard_normal((natm, 3))
            x = x + 0.5 * dt * v
            cur_mf, e_pot, f = forces(x, getattr(cur_mf, "dm", None))
            v = v + 0.5 * dt * f / m[:, None]
        else:
            # velocity Verlet
            vh = v + 0.5 * dt * f / m[:, None]
            x = x + dt * vh
            cur_mf, e_pot, f = forces(x, getattr(cur_mf, "dm", None))
            v = vh + 0.5 * dt * f / m[:, None]
            if thermostat == "csvr":
                alpha = _csvr_factor(ekin(v), e_kin_target, ndof,
                                     np.exp(-dt_fs / tau_fs), rng)
                if alpha is None:
                    v = maxwell_boltzmann(m, temperature, rng)
                else:
                    v = alpha * v

        record(step, e_pot, v)
        drift = ff.maybe_reanchor(cur_mf.cell, x)
        if drift is not None:
            log.info("md: re-anchored gradient fn (displacement %.2f bohr)",
                     drift)

    return MDResult(positions=x, velocities=v, mf=cur_mf, trajectory=traj,
                    nsteps=nsteps)


@dataclass
class NPTResult:
    positions: np.ndarray          # (natm, 3) bohr, final geometry
    velocities: np.ndarray         # (natm, 3) bohr / a.u. time
    cell: object                   # final built Cell (lattice followed P)
    mf: object                     # converged SCF at the final geometry
    # per step: dict(t_fs, positions, a, volume, e_pot, e_kin, enthalpy,
    #                temp_k, pressure_au, pressure_gpa)
    trajectory: list = field(default_factory=list)
    nsteps: int = 0

    @property
    def volumes(self):
        return np.array([rec["volume"] for rec in self.trajectory])

    @property
    def pressures_gpa(self):
        return np.array([rec["pressure_gpa"] for rec in self.trajectory])


def npt_kernel(mf, dt_fs=0.5, nsteps=20, temperature=None, pressure_gpa=0.0,
               thermostat=None, friction_fs=100.0, tau_fs=100.0,
               taup_fs=500.0, compressibility_au=1.0, velocities0=None,
               seed=0, anchor_strain=0.04, callback=None, log_every=1):
    """Constant-pressure (NPT / NPH) Born-Oppenheimer MD with an isotropic
    Berendsen barostat on the ANALYTIC stress tensor.

    Each step converges the SCF at the current (lattice, geometry) and takes
    forces AND stress from ONE reverse sweep through the anchored cell
    Lagrangian (``scf.stress.make_cell_grad_fn`` — the same evaluator serves
    every step; it is re-anchored, frozen image/Ewald lists refreshed, once
    the accumulated strain exceeds ``anchor_strain``).  The instantaneous
    pressure combines the potential (Born-Oppenheimer) stress with the
    ideal-gas kinetic term,

        P = 2*E_kin/(3V) - tr(sigma)/3 ,

    and the cell and positions are rescaled each step by the weak-coupling
    (Berendsen) factor ``mu = (1 - beta*dt/tau_p*(P0 - P))^(1/3)``.  Only
    the PRODUCT ``compressibility_au/taup_fs`` matters physically; the
    defaults give gentle first-order volume relaxation for stiff solids.
    Berendsen NPT relaxes the volume correctly but suppresses its canonical
    fluctuations (fine for equilibration; the NVE/NVT integrators in
    :func:`kernel` are the production-sampling companions).

    ``thermostat``: None (NPH — no velocity coupling), ``'langevin'``
    (BAOAB) or ``'csvr'`` as in :func:`kernel`; both need ``temperature``.
    k-points deform WITH the cell (fixed fractional k) and the FFT mesh is
    fixed, exactly as in :func:`scf.optimize.relax_cell` — the surface
    being integrated is the discretized one the SCF evaluates.  Forces have
    the COM acceleration projected out; the barostat rescales positions
    about the cell origin (fractional coordinates untouched).  The
    two-electron path is the exact plane-wave Lagrangian (the stress
    backend); ISDF per-step rebuilds are the relaxation driver's job.

    Returns an :class:`NPTResult`; ``trajectory`` records the enthalpy
    ``E_pot + E_kin + P0*V`` (the quantity a true NPT flow preserves on
    average).
    """
    from fftisdf_tpu_torch.scf import stress as scf_stress

    log = _logger(mf)
    if thermostat not in (None, "nph", "langevin", "csvr"):
        raise ValueError(f"unknown thermostat {thermostat!r}")
    if thermostat == "nph":
        thermostat = None
    if thermostat is not None and temperature is None:
        raise ValueError(f"thermostat {thermostat!r} requires a temperature")
    if getattr(mf, "trunc", None) is not None:
        raise NotImplementedError(
            "NPT with a truncated Coulomb kernel (the stress traces the "
            "bare-kernel functional)")

    cell0 = mf.cell
    assert cell0._built
    syms = cell0.atom_symbols()
    m = atom_masses(cell0)
    natm = len(m)
    ndof = max(3 * natm - 3, 1)
    dt = dt_fs / AU_TIME_FS
    p0 = pressure_gpa / GPA_PER_AU
    rng = np.random.default_rng(seed)
    kscaled0 = cell0.get_scaled_kpts(np.asarray(mf.kpts))
    mf_exxdiv = getattr(mf, "exxdiv", None)
    mf_xc = getattr(mf, "xc", None)
    mf_hub = getattr(mf, "hubbard", None)

    # anchored cell Lagrangian state (folded on re-anchor)
    a0 = np.asarray(cell0.a, dtype=np.float64)
    frac0 = np.asarray(cell0.atom_coords()) @ np.linalg.inv(a0)
    grad_fn = scf_stress.make_cell_grad_fn(cell0, mf.kpts, dtype=mf.dtype,
                                           exxdiv=mf_exxdiv, xc=mf_xc,
                                           hubbard=mf_hub, device=mf.device)

    def evaluate(A, x, dm0):
        """Converge the SCF at lattice A / Cartesian positions x; return
        (mf, cell, e_pot, forces (COM-projected), sigma (3,3), volume)."""
        eps = np.linalg.solve(a0, A) - np.eye(3)
        dfrac = x @ np.linalg.inv(A) - frac0
        new_cell = cell0.copy(
            a=A, atom=[(s, np.asarray(p)) for s, p in zip(syms, x)]).build()
        new_mf = _clone_mf(mf, new_cell,
                           kpts=kscaled0 @ new_cell.reciprocal_vectors())
        new_mf.kernel(dm0=dm0)
        if not new_mf.converged:
            raise RuntimeError("SCF failed to converge during NPT MD; "
                               "loosen conv_tol or shorten dt")
        e, geps, gfrac = grad_fn(new_mf, eps, dfrac)
        vol = float(abs(np.linalg.det(A)))
        sigma = 0.5 * (np.asarray(geps) + np.asarray(geps).T) / vol
        f = -np.asarray(gfrac, dtype=np.float64) @ np.linalg.inv(A).T
        return (new_mf, new_cell, float(e), _project_net_force(f, m),
                sigma, vol)

    A = a0.copy()
    x = np.asarray(cell0.atom_coords(), dtype=np.float64)
    if velocities0 is not None:
        v = np.asarray(velocities0, dtype=np.float64).copy()
    elif temperature is not None:
        v = maxwell_boltzmann(m, temperature, rng)
    else:
        v = np.zeros_like(x)

    cur_mf, cur_cell, e_pot, f, sigma, vol = evaluate(
        A, x, getattr(mf, "dm", None) if getattr(mf, "converged", False)
        else None)

    def ekin(v):
        return 0.5 * float((m[:, None] * v * v).sum())

    def pressure(v, sigma, vol):
        return 2.0 * ekin(v) / (3.0 * vol) - float(np.trace(sigma)) / 3.0

    traj = []

    def record(step, e_pot, v, sigma, vol):
        ek = ekin(v)
        p_inst = pressure(v, sigma, vol)
        rec = dict(t_fs=step * dt_fs, positions=x.copy(), a=A.copy(),
                   volume=vol, e_pot=e_pot, e_kin=ek,
                   enthalpy=e_pot + ek + p0 * vol,
                   temp_k=2.0 * ek / (ndof * KB_HARTREE),
                   pressure_au=p_inst, pressure_gpa=p_inst * GPA_PER_AU)
        traj.append(rec)
        if step % log_every == 0:
            log.info("npt step %4d  t=%7.2f fs  E_pot=%.10f  H=%.10f  "
                     "T=%7.1f K  P=%8.3f GPa  V=%.3f",
                     step, rec["t_fs"], e_pot, rec["enthalpy"],
                     rec["temp_k"], rec["pressure_gpa"], vol)
        if callback is not None:
            callback(step, x, v, A, e_pot, sigma)
        return p_inst

    p_inst = record(0, e_pot, v, sigma, vol)

    if thermostat == "langevin":
        gamma = 1.0 / (friction_fs / AU_TIME_FS)
        c1 = np.exp(-gamma * dt)
        c2 = np.sqrt((1.0 - c1 * c1) * KB_HARTREE * temperature / m)[:, None]
    e_kin_target = (0.5 * ndof * KB_HARTREE * temperature
                    if temperature is not None else None)
    kappa = compressibility_au * (dt_fs / taup_fs)

    for step in range(1, nsteps + 1):
        # barostat first (uses last step's P): isotropic weak coupling —
        # scale the lattice and positions, leave velocities/fractions alone
        mu = np.clip(1.0 - kappa * (p0 - p_inst), 0.5, 1.5) ** (1.0 / 3.0)
        A = mu * A
        x = mu * x

        if thermostat == "langevin":
            v = v + 0.5 * dt * f / m[:, None]
            x = x + 0.5 * dt * v
            v = c1 * v + c2 * rng.standard_normal((natm, 3))
            x = x + 0.5 * dt * v
            cur_mf, cur_cell, e_pot, f, sigma, vol = evaluate(
                A, x, getattr(cur_mf, "dm", None))
            v = v + 0.5 * dt * f / m[:, None]
        else:
            vh = v + 0.5 * dt * f / m[:, None]
            x = x + dt * vh
            cur_mf, cur_cell, e_pot, f, sigma, vol = evaluate(
                A, x, getattr(cur_mf, "dm", None))
            v = vh + 0.5 * dt * f / m[:, None]
            if thermostat == "csvr":
                alpha = _csvr_factor(ekin(v), e_kin_target, ndof,
                                     np.exp(-dt_fs / tau_fs), rng)
                if alpha is None:
                    v = maxwell_boltzmann(m, temperature, rng)
                else:
                    v = alpha * v

        p_inst = record(step, e_pot, v, sigma, vol)

        eps_now = np.linalg.solve(a0, A) - np.eye(3)
        dfrac_now = x @ np.linalg.inv(A) - frac0
        if (np.abs(eps_now).max() > anchor_strain
                or np.abs(dfrac_now).max() > 0.25):
            a0 = A.copy()
            frac0 = x @ np.linalg.inv(A)
            grad_fn = scf_stress.make_cell_grad_fn(
                cur_cell, kscaled0 @ cur_cell.reciprocal_vectors(),
                dtype=mf.dtype, exxdiv=mf_exxdiv, xc=mf_xc, hubbard=mf_hub,
                device=mf.device)
            log.info("npt: re-anchored cell Lagrangian (strain %.3f)",
                     float(np.abs(eps_now).max()))

    return NPTResult(positions=x, velocities=v, cell=cur_cell, mf=cur_mf,
                     trajectory=traj, nsteps=nsteps)
