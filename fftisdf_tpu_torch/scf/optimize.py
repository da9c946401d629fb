"""Geometry optimisation on the analytic nuclear gradients.

Counterpart of ``fftisdf_tpu/scf/optimize.py``.  BFGS on the flattened
Cartesian coordinates with a trust-radius step cap; each step re-converges
the SCF at the displaced geometry (warm-started from the previous density)
and takes the force from one reverse-mode sweep through the whole stack
(``scf.grad``).  The gradient tracks the discretised energy surface
(egg-box included), so the optimiser descends the surface the SCF
evaluates.  Net translations are projected out of every step.

:func:`relax_cell` relaxes the lattice too: BFGS on [strain (6),
fractional atoms] through the anchored cell Lagrangian of ``scf.stress``.

The drivers are numpy on the host; the SCFs, ISDF builds and gradient
sweeps run on the device of the SCF they start from.
"""
import inspect
from dataclasses import dataclass, field

import numpy as np

from fftisdf_tpu_torch.scf import grad as scf_grad
from fftisdf_tpu_torch.utils.logging import Logger


@dataclass
class OptResult:
    converged: bool
    positions: np.ndarray          # (natm, 3) bohr, final geometry
    energy: float                  # final total energy (Ha)
    grad: np.ndarray               # (natm, 3) final gradient (Ha/bohr)
    mf: object                     # converged SCF at the final geometry
    trajectory: list = field(default_factory=list)  # [(positions, e, fmax)]
    nsteps: int = 0


# constructor arguments a clone does not copy: the geometry, the J/K
# provider and the log level (a clone is silent)
_CLONE_SKIP = {"self", "cell", "kpts", "with_df", "verbose"}


def _init_params(cls):
    """Names of the constructor arguments along the class's MRO (the SCF
    classes pass their knobs down through ``**kw``)."""
    names = []
    for c in cls.__mro__:
        init = c.__dict__.get("__init__")
        if init is None:
            continue
        for p in inspect.signature(init).parameters.values():
            if p.kind in (p.VAR_KEYWORD, p.VAR_POSITIONAL):
                continue
            if p.name not in names:
                names.append(p.name)
    return names


def _clone_mf(mf, cell, kpts=None, with_df=None):
    """A fresh SCF object of ``mf``'s class at another geometry, with the
    same knobs: every constructor argument along the class's MRO that the
    object holds under its own name (``init_spin``, ``spin_bias``,
    ``smearing``, ``xc``, ``hubbard``, ``exxdiv``, ``dtype``, ``device``
    ...), but the geometry, the J/K provider (``with_df``; None gives the
    class's default) and the outputs, which the constructor resets."""
    kw = {n: getattr(mf, n) for n in _init_params(type(mf))
          if n not in _CLONE_SKIP and hasattr(mf, n)}
    kw["verbose"] = 0
    return type(mf)(cell, mf.kpts if kpts is None else kpts, with_df=with_df,
                    **kw)


def _logger(mf):
    return Logger(getattr(getattr(mf, "_log", None), "verbose", 3))


class BOForceField:
    """Born-Oppenheimer force evaluator shared by the geometry-sweeping
    drivers (relaxation, molecular dynamics, finite-difference Hessians).

    ``ff(positions, dm0) -> (mf, energy, grad)`` re-converges the SCF at
    the geometry (warm-started from ``dm0``) and takes the analytic
    gradient from one reverse-mode sweep.  Exact-PW forces reuse one
    gradient closure across geometries; :meth:`maybe_reanchor` rebuilds
    it, with the same functional, once the geometry drifts more than
    ``anchor_drift`` bohr from its reference.  The ISDF backend builds a
    fresh ``FFTISDF`` (``isdf_kwargs``) at every geometry, which serves
    both the SCF's J/K and the gradient's frozen-point energy."""

    def __init__(self, mf, two_electron="pw", isdf_kwargs=None,
                 anchor_drift=1.0):
        if getattr(mf, "trunc", None) is not None:
            raise NotImplementedError(
                "geometry sweeps with a truncated Coulomb kernel "
                "(forces trace the bare-kernel functional)")
        assert mf.cell._built
        self.mf0 = mf
        self.cell = mf.cell
        self.two_electron = two_electron
        self.isdf_kwargs = isdf_kwargs or {}
        self.anchor_drift = anchor_drift
        self._anchor = np.asarray(mf.cell.atom_coords(), dtype=np.float64)
        self._pw_grad = (self._trace(mf.cell) if two_electron == "pw"
                         else None)

    def _trace(self, cell):
        mf = self.mf0
        return scf_grad.make_grad_fn(
            cell, mf.kpts, two_electron="pw",
            exxdiv=getattr(mf, "exxdiv", None), xc=getattr(mf, "xc", None),
            hubbard=getattr(mf, "hubbard", None), device=mf.device)

    def eval_converged(self, mf):
        """(energy, grad) of an already-converged SCF at its own geometry
        (the isdf path needs ``mf.with_df`` to be a built FFTISDF)."""
        if self._pw_grad is not None:
            g, e = self._pw_grad(mf)
        else:
            g, e = scf_grad.kernel(mf, two_electron=self.two_electron,
                                   df=mf.with_df)
        return float(e), np.asarray(g, dtype=np.float64)

    def __call__(self, positions, dm0=None):
        new_cell = self.cell.copy(
            atom=[(sym, np.asarray(p)) for sym, p in
                  zip(self.cell.atom_symbols(), positions)]).build()
        df = None
        if self.two_electron == "isdf":
            from fftisdf_tpu_torch.isdf import FFTISDF

            df = FFTISDF(new_cell, self.mf0.kpts, dtype=self.mf0.dtype,
                         verbose=0, device=self.mf0.device,
                         **self.isdf_kwargs).build()
        new_mf = _clone_mf(self.mf0, new_cell, with_df=df)
        new_mf.kernel(dm0=dm0)
        if not new_mf.converged:
            raise RuntimeError("SCF failed to converge during the geometry "
                               "sweep; loosen conv_tol or improve the start")
        e, g = self.eval_converged(new_mf)
        return new_mf, e, g

    def maybe_reanchor(self, cell, positions):
        """Rebuild the exact-PW gradient closure at ``cell`` when the
        geometry drifted more than ``anchor_drift`` bohr from its
        reference.  Returns the drift if it did, else None."""
        drift = float(np.abs(np.asarray(positions, dtype=np.float64)
                             - self._anchor).max())
        if self._pw_grad is not None and drift > self.anchor_drift:
            self._pw_grad = self._trace(cell)
            self._anchor = np.asarray(positions, dtype=np.float64).copy()
            return drift
        return None


def kernel(mf, fmax=5e-4, max_steps=50, step_max=0.2, two_electron="pw",
           isdf_kwargs=None, callback=None):
    """Relax the atoms of ``mf.cell`` until ``max|grad| < fmax`` (Ha/bohr).

    ``mf`` may be converged or not.  With ``two_electron='isdf'`` a fresh
    ``FFTISDF`` (``isdf_kwargs``: c0, m0, solver, ...) is built at every
    geometry and serves both the SCF and the gradient, so forces stay
    consistent with the energy being minimised.  Returns an
    :class:`OptResult`."""
    log = _logger(mf)
    cell = mf.cell
    ff = BOForceField(mf, two_electron=two_electron,
                      isdf_kwargs=isdf_kwargs)
    x = np.asarray(cell.atom_coords(), dtype=np.float64).ravel()
    n = x.size
    usable = (getattr(mf, "dm", None) is not None and mf.converged
              and (two_electron != "isdf"
                   or getattr(mf.with_df, "wq", None) is not None))
    if usable:
        e, g = ff.eval_converged(mf)
        cur_mf = mf
    else:
        cur_mf, e, g = ff(x.reshape(-1, 3), None)

    H = np.eye(n)  # inverse-Hessian estimate (bohr^2/Ha)
    traj = []
    converged = False
    for step in range(max_steps + 1):
        gv = g - g.mean(axis=0, keepdims=True)  # project out translation
        f_inf = np.abs(gv).max()
        traj.append((x.reshape(-1, 3).copy(), e, float(f_inf)))
        log.info("relax step %d  E=%.10f  max|F|=%.3e", step, e, f_inf)
        if callback is not None:
            callback(step, x.reshape(-1, 3), e, g)
        if f_inf < fmax:
            converged = True
            break
        if step == max_steps:
            break

        p = -H @ gv.ravel()
        p = (p.reshape(-1, 3) - p.reshape(-1, 3).mean(axis=0)).ravel()
        pn = np.linalg.norm(p)
        if pn > step_max * np.sqrt(len(p) / 3):
            p *= step_max * np.sqrt(len(p) / 3) / pn
        x_new = x + p
        mf_new, e_new, g_new = ff(x_new.reshape(-1, 3),
                                  getattr(cur_mf, "dm", None))
        gv_new = g_new - g_new.mean(axis=0, keepdims=True)
        # backtrack once if the quasi-Newton step overshot badly
        if e_new > e + 1e-12 and np.abs(gv_new).max() > f_inf:
            p *= 0.25
            x_new = x + p
            mf_new, e_new, g_new = ff(x_new.reshape(-1, 3),
                                      getattr(cur_mf, "dm", None))
            gv_new = g_new - g_new.mean(axis=0, keepdims=True)
        # BFGS update of the inverse Hessian (curvature-guarded)
        s = x_new - x
        y = (gv_new - gv).ravel()
        sy = float(s @ y)
        if sy > 1e-12:
            rho = 1.0 / sy
            V = np.eye(n) - rho * np.outer(s, y)
            H = V @ H @ V.T + rho * np.outer(s, s)
        x, e, g, cur_mf = x_new, e_new, g_new, mf_new
        drift = ff.maybe_reanchor(cur_mf.cell, x.reshape(-1, 3))
        if drift is not None:
            log.info("relax: re-anchored gradient fn (displacement %.2f "
                     "bohr)", drift)

    return OptResult(converged=converged, positions=x.reshape(-1, 3),
                     energy=e, grad=g, mf=cur_mf, trajectory=traj,
                     nsteps=len(traj) - 1)


@dataclass
class CellOptResult:
    converged: bool
    cell: object                   # final built Cell
    energy: float
    sigma: np.ndarray              # (3,3) final stress (Ha/bohr^3)
    forces_max: float              # final max Cartesian force component
    mf: object
    trajectory: list = field(default_factory=list)  # [(e, max|F|, max|s|)]
    nsteps: int = 0


def relax_cell(mf, fmax=5e-4, smax=2e-5, max_steps=40, step_max=0.1,
               relax_atoms=True, re_anchor=0.04, callback=None):
    """Variable-cell relaxation: BFGS on [strain (6), fractional atoms].

    One cell Lagrangian (``scf.stress.make_cell_energy_fn``, anchored at
    the starting lattice) yields the stress and the forces per step in a
    single reverse sweep; the SCF is re-converged at every (eps, dfrac)
    iterate on the same FFT mesh, with k-points at fixed fractional
    coordinates.  Converged when max Cartesian force < ``fmax`` (Ha/bohr)
    and max |sigma| < ``smax`` (Ha/bohr^3); ``relax_atoms=False`` freezes
    the fractional coordinates.  The Lagrangian is re-anchored at the
    current cell when the accumulated strain exceeds ``re_anchor`` (or
    displacements 5 ``step_max``), keeping the BFGS curvature."""
    from fftisdf_tpu_torch.scf import stress as scf_stress

    log = _logger(mf)
    cell0 = mf.cell
    assert cell0._built
    a0 = np.asarray(cell0.a)
    frac0 = np.asarray(cell0.atom_coords()) @ np.linalg.inv(a0)
    syms = cell0.atom_symbols()
    natm = len(syms)
    kscaled0 = cell0.get_scaled_kpts(np.asarray(mf.kpts))
    fkw = dict(dtype=mf.dtype, exxdiv=getattr(mf, "exxdiv", None),
               xc=getattr(mf, "xc", None),
               hubbard=getattr(mf, "hubbard", None), device=mf.device)
    grad_fn = scf_stress.make_cell_grad_fn(cell0, mf.kpts, **fkw)

    def scf_at(eps, dfrac, dm0):
        A = a0 @ (np.eye(3) + eps)
        new_cell = cell0.copy(
            a=A, atom=[(s, f @ A) for s, f in zip(syms, frac0 + dfrac)],
        ).build()
        new_mf = _clone_mf(mf, new_cell,
                           kpts=kscaled0 @ new_cell.reciprocal_vectors())
        new_mf.kernel(dm0=dm0)
        if not new_mf.converged:
            raise RuntimeError("SCF failed to converge during cell "
                               "relaxation")
        val, geps, gfrac = grad_fn(new_mf, eps, dfrac)
        return new_mf, new_cell, val, geps, gfrac

    iu = np.triu_indices(3)

    def pack_grad(geps, gfrac):
        gs = geps + geps.T
        g6 = gs[iu] * np.where(iu[0] == iu[1], 0.5, 1.0)
        return np.concatenate([g6, gfrac.ravel()])

    def unpack(x):
        eps = np.zeros((3, 3))
        eps[iu] = x[:6]
        eps = eps + eps.T - np.diag(np.diag(eps))
        return eps, x[6:].reshape(natm, 3)

    x = np.zeros(6 + 3 * natm)
    cur_mf, cur_cell, e, geps, gfrac = scf_at(*unpack(x),
                                              getattr(mf, "dm", None))
    n = x.size
    # strain curvature is O(vol * elastic modulus): 1/vol seeds the first
    # strain step at ~sigma
    vol0 = float(cell0.vol)
    H = np.diag(np.concatenate([np.full(6, 1.0 / vol0), np.ones(3 * natm)]))
    eps_cap = 0.02  # per-step strain cap (image lists frozen at reference)
    traj = []
    converged = False

    def _project(gvec):
        gv = gvec.copy()
        gv[6:] = (gv[6:].reshape(natm, 3)
                  - gv[6:].reshape(natm, 3).mean(axis=0)).ravel()
        if not relax_atoms:
            gv[6:] = 0.0
        return gv

    for step in range(max_steps + 1):
        eps, dfrac = unpack(x)
        A = a0 @ (np.eye(3) + eps)
        vol = float(abs(np.linalg.det(A)))
        sigma = 0.5 * (geps + geps.T) / vol
        g_cart = gfrac @ np.linalg.inv(A).T
        g_cart -= g_cart.mean(axis=0, keepdims=True)
        f_inf = float(np.abs(g_cart).max())
        s_inf = float(np.abs(sigma).max())
        traj.append((e, f_inf, s_inf))
        log.info("relax_cell step %d  E=%.10f  max|F|=%.3e  max|s|=%.3e",
                 step, e, f_inf, s_inf)
        if callback is not None:
            callback(step, eps, dfrac, e, sigma, g_cart)
        if (f_inf < fmax or not relax_atoms) and s_inf < smax:
            converged = True
            break
        if step == max_steps:
            break

        g = _project(pack_grad(geps, gfrac))
        p = _project(-H @ g)
        scale = min(1.0,
                    eps_cap / max(np.abs(p[:6]).max(), 1e-30),
                    step_max / max(np.abs(p[6:]).max(), 1e-30))
        p *= scale
        x_new = x + p
        mf_new, cell_new, e_new, geps_new, gfrac_new = scf_at(
            *unpack(x_new), getattr(cur_mf, "dm", None))
        g_new = _project(pack_grad(geps_new, gfrac_new))
        if e_new > e + 1e-12 and np.abs(g_new).max() > np.abs(g).max():
            p *= 0.25
            x_new = x + p
            mf_new, cell_new, e_new, geps_new, gfrac_new = scf_at(
                *unpack(x_new), getattr(cur_mf, "dm", None))
            g_new = _project(pack_grad(geps_new, gfrac_new))
        s = x_new - x
        y = g_new - g
        sy = float(s @ y)
        if sy > 1e-12:
            rho = 1.0 / sy
            V = np.eye(n) - rho * np.outer(s, y)
            H = V @ H @ V.T + rho * np.outer(s, s)
        x, e = x_new, e_new
        geps, gfrac = geps_new, gfrac_new
        cur_mf, cur_cell = mf_new, cell_new

        eps_now, dfrac_now = unpack(x)
        # capped steps (eps_cap, step_max) put the accumulated strain and
        # displacement on these thresholds in exact arithmetic, where
        # roundoff, which differs between devices, would decide: a margin
        # of 1e-9 keeps the decision off it
        if (np.abs(eps_now).max() > re_anchor * (1 + 1e-9)
                or np.abs(dfrac_now).max() > 5 * step_max * (1 + 1e-9)):
            # fold the deformation into the reference and re-anchor
            a0 = a0 @ (np.eye(3) + eps_now)
            frac0 = frac0 + dfrac_now
            grad_fn = scf_stress.make_cell_grad_fn(
                cur_cell, kscaled0 @ cur_cell.reciprocal_vectors(), **fkw)
            x = np.zeros(n)
            _, geps, gfrac = grad_fn(cur_mf)
            log.info("relax_cell: re-anchored (accumulated strain %.3f)",
                     float(np.abs(eps_now).max()))

    eps, dfrac = unpack(x)
    A = a0 @ (np.eye(3) + eps)
    vol = float(abs(np.linalg.det(A)))
    sigma = 0.5 * (geps + geps.T) / vol
    g_cart = gfrac @ np.linalg.inv(A).T
    g_cart -= g_cart.mean(axis=0, keepdims=True)
    return CellOptResult(converged=converged, cell=cur_cell, energy=e,
                         sigma=sigma, forces_max=float(np.abs(g_cart).max()),
                         mf=cur_mf, trajectory=traj, nsteps=len(traj) - 1)
