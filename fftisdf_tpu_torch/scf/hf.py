"""k-point Hartree-Fock (KRHF / KUHF) with DIIS on top of any J/K provider.

Counterpart of the host SCF loops of ``fftisdf_tpu/scf/hf.py``.  J/K
come from the provider ``with_df`` on its device: an
:class:`~fftisdf_tpu_torch.isdf.kpoint.FFTISDF` (the fast path) or, when
``with_df`` is None, :class:`PWDF` (the exact plane-wave oracle).  The
one-electron setup runs on ``device``; the per-k algebra of the loop
(generalised eigensolves, densities, DIIS) is small and runs on the host
in complex128 (``scf.device`` keeps it on the card).  ``exxdiv`` is None
(the reference's convention) or ``'ewald'``.  ``dtype`` (float64 unless
``torch.float32`` is asked for) is the precision of the one-electron
integrals and of a default :class:`PWDF`; the overlap cutoff of the
canonical orthogonalisation follows it (1e-10 / 2e-6).

``trunc`` (or a truncated ``with_df``, whose truncation is adopted and
must agree) truncates J/K, the electron-ion and the ion-ion interaction
alike: an isolated molecule (0d) or slab (2d) in a periodic box.  Band
energies at any k-points come from the converged density
(:meth:`KRHF.get_bands`: served from the ISDF product state, or by the
exact plane-wave band path), and a driver checkpoints to one ``.npz``
(:meth:`KRHF.save`, :meth:`KRHF.load_chk`) in the JAX package's format.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf.jk import add_ewald_exx
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.coulomb import trunc_for_cell
from fftisdf_tpu_torch.pw import jk as pw_jk
from fftisdf_tpu_torch.scf import integrals
from fftisdf_tpu_torch.scf.core import (adiis_coeffs, diis_extrapolate,
                                        fixed_occupations,
                                        smeared_occupations)
from fftisdf_tpu_torch.utils.device import (as_tensor, free_memory_bytes,
                                            real_complex, resolve_device,
                                            to_numpy)
from fftisdf_tpu_torch.utils import profiling, serialization
from fftisdf_tpu_torch.utils.logging import Logger


class PWDF:
    """Exact plane-wave J/K provider (the FFTDF oracle) with the
    ``get_jk`` interface of :class:`~fftisdf_tpu_torch.isdf.kpoint.FFTISDF`.
    Holds the full-grid AO tensor (nk, ngrid, nao) on ``device``, in
    ``dtype``; ``trunc`` ('0d' | '2d' | (kind, rc)) serves the truncated
    kernel."""

    def __init__(self, cell, kpts, dtype=None, trunc=None, *, device="cuda"):
        self.device = resolve_device(device)
        self.cell = cell
        self.kpts = np.asarray(kpts)
        self.coords = cell.gen_uniform_grids()
        self.ao = make_evaluator(cell, kpts=self.kpts, dtype=dtype,
                                 device=self.device)(self.coords)
        self.trunc = (trunc_for_cell(cell, trunc) if isinstance(trunc, str)
                      else trunc)
        self._madelung = None
        self._s1e = None

    def get_jk(self, dm, with_j=True, with_k=True, exxdiv=None, omega=None):
        if exxdiv not in (None, "ewald"):
            raise NotImplementedError(f"exxdiv={exxdiv!r} not supported")
        omega = float(omega or 0.0)
        if exxdiv is not None and omega != 0.0:
            # a range-separated kernel has no q+G = 0 divergence to correct
            raise NotImplementedError("exxdiv with omega")
        dm = as_tensor(dm, self.device, self.ao.dtype)
        if dm.ndim == 4:                                  # spin/set axis
            out = [self.get_jk(d, with_j, with_k, exxdiv, omega=omega)
                   for d in dm]
            return (torch.stack([o[0] for o in out]) if with_j else None,
                    torch.stack([o[1] for o in out]) if with_k else None)
        vj = (pw_jk.get_j_kpts(self.cell, dm, self.ao, omega=omega,
                               trunc=self.trunc) if with_j else None)
        vk = (pw_jk.get_k_kpts(self.cell, dm, self.ao, self.kpts,
                               coords=self.coords, omega=omega,
                               trunc=self.trunc) if with_k else None)
        if exxdiv == "ewald" and with_k:
            if self._madelung is None:
                kmesh = kpt_mod.kpts_to_kmesh(self.cell, self.kpts)
                # a truncated kernel drops nothing at q+G = 0: its constant
                # is the kernel's Riemann-sum-vs-integral defect (0 for 0d)
                self._madelung = (
                    integrals.madelung_trunc(self.cell, kmesh, self.trunc)
                    if self.trunc is not None
                    else integrals.madelung(self.cell, kmesh))
                self._s1e = integrals.get_ovlp(self.cell, self.ao)
            vk = add_ewald_exx(vk, self._s1e, dm, self._madelung)
        return vj, vk


class DIIS:
    """ADIIS-stabilised Pulay DIIS over flattened (dm, fock, error) rows:
    ADIIS coefficients while the commutator error exceeds
    ``adiis_switch`` (and a density is stored), CDIIS after."""

    def __init__(self, space=8, adiis_switch=1e-2):
        self.space = space
        self.adiis_switch = float(adiis_switch)
        self.errs = []
        self.focks = []
        self.dms = []

    def update(self, fock_flat, err_flat, dm_flat=None):
        self.errs.append(np.asarray(err_flat, dtype=np.complex128))
        self.focks.append(np.asarray(fock_flat, dtype=np.complex128))
        self.dms.append(None if dm_flat is None
                        else np.asarray(dm_flat, dtype=np.complex128))
        if len(self.errs) > self.space:
            self.errs.pop(0)
            self.focks.pop(0)
            self.dms.pop(0)
        n = len(self.errs)
        err_norm = float(np.abs(self.errs[-1]).max())
        valid = np.array([d is not None for d in self.dms])
        focks = torch.from_numpy(np.asarray(self.focks))
        if (self.adiis_switch > 0 and self.dms[-1] is not None
                and valid.sum() >= 2 and err_norm > self.adiis_switch):
            dms = np.stack([np.zeros_like(self.focks[0]) if d is None else d
                            for d in self.dms])
            c = adiis_coeffs(torch.from_numpy(dms), focks, n - 1,
                             torch.from_numpy(valid))
            return (c.to(focks.dtype) @ focks).numpy()
        return diis_extrapolate(torch.from_numpy(np.asarray(self.errs)),
                                focks, torch.ones(n, dtype=torch.bool)
                                ).numpy()


def _eigh_gen(f, s, cutoff=1e-10):
    """F C = S C e by canonical orthogonalisation (overlap eigenvalues below
    ``cutoff * max`` are dropped)."""
    se, sv = np.linalg.eigh(s)
    keep = se > cutoff * se.max()
    x = sv[:, keep] / np.sqrt(se[keep])[None, :]
    e, c = np.linalg.eigh(x.conj().T @ f @ x)
    return e, x @ c


def _build_dm(mo_coeff, mo_occ):
    return np.einsum("kmi,ki,kni->kmn", mo_coeff, mo_occ, mo_coeff.conj())


def _setup_one_electron(cell, kpts, device, log, dtype=None, trunc=None,
                        keep_ao=False):
    """(s1e, h1e, ao) with s1e/h1e on the host in complex128, from AO
    tensors built on ``device`` in ``dtype``, in k-chunks sized from its
    free memory: the full-grid AO tensor of one k plus the kinetic FFT
    planes and the projector values cost about ngrid (3 nao + nproj)
    complex numbers.  ``trunc``: the truncated local pseudopotential.
    ``keep_ao``: the chunks are also gathered into the full-grid AO tensor
    (nk, ngrid, nao) on ``device``, returned as ``ao`` (None otherwise)."""
    rdt, cdt = real_complex(dtype)
    coords = cell.gen_uniform_grids()
    ng = coords.shape[0]
    nao = cell.nao_nr()
    nproj = len(integrals._projector_shells(cell)[1])
    nk = len(kpts)
    ao_all = (torch.empty((nk, ng, nao), dtype=cdt, device=device)
              if keep_ao else None)
    per_k = ng * (3 * nao + nproj) * cdt.itemsize
    kchunk = int(max(1, min(nk, 0.5 * free_memory_bytes(device) // per_k)))
    coords_t = torch.as_tensor(coords, dtype=rdt, device=device)
    vgrid = integrals.vloc_on_grid(cell, trunc=trunc, dtype=rdt,
                                   device=device)
    s_parts, h_parts = [], []
    for k0 in range(0, nk, kchunk):
        kp = kpts[k0:k0 + kchunk]
        ao = make_evaluator(cell, kpts=kp, dtype=rdt,
                            device=device)(coords_t)
        if keep_ao:
            ao_all[k0:k0 + len(kp)] = ao
        s_parts.append(to_numpy(integrals.get_ovlp(cell, ao)))
        h = (integrals.get_kinetic(cell, ao, kp, coords)
             + integrals.get_vloc(cell, ao, vgrid)
             + integrals.get_vnl(cell, ao, kp))
        h_parts.append(to_numpy(h))
        del ao, h
    log.debug("setup: %d k-chunk(s) of %d", -(-nk // kchunk), kchunk)
    return (np.concatenate(s_parts).astype(np.complex128),
            np.concatenate(h_parts).astype(np.complex128), ao_all)


class KRHF:
    """Restricted HF over a uniform k-mesh (fixed or smeared occupations).

    ``with_df`` is the J/K provider (None: a :class:`PWDF` on ``device``);
    ``device`` is where the one-electron integrals are built, in ``dtype``
    (float64 when None); ``ovlp_cutoff`` None is 1e-10 for float64
    integrals and 2e-6 for float32 ones, whose quadrature noise in
    near-null overlap directions would otherwise be amplified; ``exxdiv``
    None or ``'ewald'`` is passed to the provider.  ``trunc`` ('0d' | '2d'
    | (kind, rc)) truncates J/K, the local pseudopotential and the ion-ion
    energy; it is adopted from ``with_df`` when that carries one, and must
    agree with it otherwise."""

    def __init__(self, cell, kpts, with_df=None, max_cycle=50, conv_tol=1e-8,
                 diis_space=8, adiis_switch=1e-2, exxdiv=None,
                 level_shift=0.0, damp=0.0, smearing=0.0,
                 smearing_method="fermi", trunc=None, ovlp_cutoff=None,
                 dtype=None, verbose=3, *, device="cuda"):
        if exxdiv not in (None, "ewald"):
            raise NotImplementedError(f"exxdiv={exxdiv!r} not supported")
        # the metric the provider serves must match hcore and e_nuc
        if isinstance(trunc, str):
            trunc = trunc_for_cell(cell, trunc)
        df_trunc = getattr(with_df, "trunc", None)
        if trunc is None:
            trunc = df_trunc
        elif df_trunc is not None and (
                df_trunc[0] != trunc[0]
                or abs(df_trunc[1] - trunc[1]) > 1e-10):
            raise ValueError(f"with_df truncation {df_trunc} != SCF "
                             f"truncation {trunc}")
        self.trunc = trunc
        self.device = resolve_device(device)
        self.dtype = real_complex(dtype)[0]
        if ovlp_cutoff is None:
            ovlp_cutoff = 1e-10 if self.dtype == torch.float64 else 2e-6
        self.cell = cell
        self.kpts = np.asarray(kpts)
        self.with_df = with_df
        self.max_cycle = max_cycle
        self.conv_tol = conv_tol
        self.diis_space = diis_space
        self.adiis_switch = adiis_switch
        self.exxdiv = exxdiv
        self.level_shift = level_shift
        self.damp = damp
        self.smearing = smearing
        self.smearing_method = smearing_method
        self.ovlp_cutoff = ovlp_cutoff
        self._log = Logger(verbose)
        self.e_tot = None
        self.e_free = None
        self.entropy = 0.0
        self.mu = None
        self.mo_energy = self.mo_coeff = self.mo_occ = None
        self.dm = None
        self.converged = False
        self.cycles = 0
        self.cycle_seconds = []
        # a driver that reads the AO tensor every cycle (scf.ks) keeps the
        # setup's; the exact oracle's own is reused instead (_get_ao)
        keep = (self._keeps_ao() and with_df is not None
                and not isinstance(with_df, PWDF))
        with profiling.span("scf.one_electron"):
            self.s1e, self.h1e, self._ao = _setup_one_electron(
                cell, self.kpts, self.device, self._log, dtype=self.dtype,
                trunc=trunc, keep_ao=keep)
        self.e_nuc = (integrals.energy_nuc_trunc(cell, trunc)
                      if trunc is not None else integrals.ewald(cell))
        if self.with_df is None:
            self.with_df = PWDF(cell, self.kpts, dtype=self.dtype,
                                trunc=trunc, device=self.device)

    def _keeps_ao(self):
        """Whether the driver keeps the full-grid AO tensor of its setup:
        only drivers that read it every cycle do."""
        return False

    def _get_ao(self):
        """Full-grid AO tensor (nk, ngrid, nao) on ``device``: the setup's
        when the driver kept it, else built at the first call (the exact
        band path needs it; the ISDF HF path never does), a :class:`PWDF`
        provider's own tensor when it has the driver's precision."""
        if self._ao is None:
            ao = getattr(self.with_df, "ao", None)
            if (isinstance(self.with_df, PWDF)
                    and ao.dtype == real_complex(self.dtype)[1]):
                self._ao = ao
            else:
                self._ao = make_evaluator(
                    self.cell, kpts=self.kpts, dtype=self.dtype,
                    device=self.device)(self.cell.gen_uniform_grids())
        return self._ao

    def save(self, path):
        """Checkpoint the SCF state (density, orbitals, energies) to one
        ``.npz`` (``utils.serialization.save_scf``)."""
        return serialization.save_scf(path, self)

    def load_chk(self, path):
        """The density of a checkpoint, its geometry checked against this
        driver's: ``mf.kernel(dm0=mf.load_chk(path))``."""
        return serialization.load_scf(path, cell=self.cell,
                                      kpts=self.kpts)["dm"]

    @property
    def nocc(self):
        ne = self.cell.nelectron
        if ne % 2:
            raise ValueError("odd electron count: use KUHF")
        return ne // 2

    def get_init_guess(self):
        """Aufbau occupation of the hcore eigenvectors."""
        es, cs = [], []
        for k in range(self.h1e.shape[0]):
            e, c = _eigh_gen(self.h1e[k], self.s1e[k],
                             cutoff=self.ovlp_cutoff)
            es.append(e)
            cs.append(c)
        occs = fixed_occupations(es, self.nocc, factor=2.0)
        return _build_dm(np.asarray(cs), np.asarray(occs))

    def _jk(self, dm):
        vj, vk = self.with_df.get_jk(dm, exxdiv=self.exxdiv)
        return (to_numpy(vj).astype(np.complex128, copy=False),
                to_numpy(vk).astype(np.complex128, copy=False))

    def get_fock(self, dm):
        vj, vk = self._jk(dm)
        return self.h1e + vj - 0.5 * vk, vj, vk

    def _occupations(self, es):
        if self.smearing > 0:
            occs, self.mu, self.entropy = smeared_occupations(
                es, self.nocc, self.smearing, self.smearing_method,
                factor=2.0)
            return occs
        self.entropy = 0.0
        return fixed_occupations(es, self.nocc, factor=2.0)

    def energy_elec(self, dm, vj, vk):
        nk = len(self.kpts)
        e1 = np.einsum("kmn,knm->", dm, self.h1e).real / nk
        e2 = 0.5 * np.einsum("kmn,knm->", dm, vj - 0.5 * vk).real / nk
        return e1 + e2

    def kernel(self, dm0=None):
        log = self._log
        dm = self.get_init_guess() if dm0 is None else np.asarray(dm0)
        diis = DIIS(self.diis_space, adiis_switch=self.adiis_switch)
        nk = self.h1e.shape[0]
        e_last = 0.0
        it = -1
        self.cycle_seconds = []
        for it in range(self.max_cycle):
            t0 = time.perf_counter()
            fock, vj, vk = self.get_fock(dm)
            e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
            err = np.stack([
                fock[k] @ dm[k] @ self.s1e[k] - self.s1e[k] @ dm[k] @ fock[k]
                for k in range(nk)])
            fock = diis.update(fock.reshape(-1), err.reshape(-1),
                               dm_flat=dm.reshape(-1)).reshape(fock.shape)
            if self.level_shift:
                fock = fock + self.level_shift * np.stack([
                    self.s1e[k] - self.s1e[k] @ dm[k] @ self.s1e[k] / 2.0
                    for k in range(nk)])
            es, cs = [], []
            for k in range(nk):
                e, c = _eigh_gen(fock[k], self.s1e[k],
                                 cutoff=self.ovlp_cutoff)
                es.append(e)
                cs.append(c)
            occs = self._occupations(es)
            dm_new = _build_dm(np.asarray(cs), np.asarray(occs))
            if self.damp:
                dm_new = (1.0 - self.damp) * dm_new + self.damp * dm
            ddm = abs(dm_new - dm).max()
            de = abs(e_tot - e_last)
            self.cycle_seconds.append(time.perf_counter() - t0)
            log.info("SCF it %2d  E = %.10f  dE = %.2e  |ddm| = %.2e (%.2fs)",
                     it, e_tot, de, ddm, self.cycle_seconds[-1])
            dm = dm_new
            e_last = e_tot
            if de < self.conv_tol and ddm < np.sqrt(self.conv_tol):
                self.converged = True
                break
        self.cycles = it + 1
        fock, vj, vk = self.get_fock(dm)
        self.e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
        self.e_free = self.e_tot - self.smearing * self.entropy / nk
        self.mo_energy = np.asarray(es)
        self.mo_coeff = np.asarray(cs)
        self.mo_occ = np.asarray(occs)
        self.dm = dm
        return self.e_tot

    # --------------------------------------------------------------
    def _band_ingredients(self, kpts_band, dm, with_k=True,
                          return_ao=False):
        """(s1e_b, h1e_b, vj_b, vk_b[, ao_b]) at band k-points from the mesh
        density, on the host in complex128.

        An ISDF provider serves band J/K from its product state
        (``isdf.bands``); otherwise the exact plane-wave band path runs
        (one Poisson solve for the k-independent Hartree potential, the
        (band, mesh) pair sweep for exchange, dropping exactly the
        argmin-|q+G|^2 sample strictly inside the minimum q-lattice plane
        spacing).  With ``exxdiv='ewald'`` the probe-charge term needs the
        density at the band point, so it exists at mesh points only:
        off-mesh points raise ``ValueError``.  ``with_k=False`` (pure KS
        functionals, ``scf.ks``) skips exchange and returns ``vk_b = 0.0``;
        ``return_ao`` also returns the band-point AO tensor (nb, ngrid,
        nao) on the device, for the KS drivers' xc matrix elements."""
        from fftisdf_tpu_torch.isdf.bands import _qlat_dmin2

        cell = self.cell
        kpts_band = np.asarray(kpts_band, dtype=np.float64).reshape(-1, 3)
        coords = cell.gen_uniform_grids()
        aob = make_evaluator(cell, kpts=kpts_band, dtype=self.dtype,
                             device=self.device)(coords)
        s1e_b = integrals.get_ovlp(cell, aob)
        h1e_b = integrals.get_hcore(cell, aob, kpts_band, coords,
                                    trunc=self.trunc)
        kmesh = kpt_mod.kpts_to_kmesh(cell, self.kpts)
        if getattr(self.with_df, "wq", None) is not None:
            vj_b, vk_b = self.with_df.get_jk(dm, kpts_band=kpts_band,
                                             with_k=with_k)
        else:
            ao = self._get_ao()
            dmt = as_tensor(dm, ao.device, ao.dtype)
            dms = dmt if dmt.ndim == 4 else dmt[None]
            vj_b = torch.stack([pw_jk.get_j_kpts(cell, d, ao, ao_band=aob,
                                                 trunc=self.trunc)
                                for d in dms])
            vk_b = torch.stack([
                pw_jk.get_k_kpts(cell, d, ao, self.kpts, coords=coords,
                                 ao_band=aob, kpts_band=kpts_band,
                                 g0_argmin_thresh=_qlat_dmin2(cell, kmesh),
                                 trunc=self.trunc)
                for d in dms]) if with_k else None
            if dmt.ndim == 3:
                vj_b = vj_b[0]
                vk_b = None if vk_b is None else vk_b[0]
        if self.exxdiv == "ewald" and with_k:
            scaled = cell.get_scaled_kpts(kpts_band)
            smesh = cell.get_scaled_kpts(self.kpts)
            idx = [kpt_mod.member(sb, smesh, strict=False) for sb in scaled]
            if any(i < 0 for i in idx):
                raise ValueError(
                    "exxdiv='ewald' band energies are defined only at the "
                    "SCF mesh k-points; run get_bands with exxdiv=None "
                    "(set self.exxdiv = None after the SCF) for off-mesh "
                    "paths")
            mad = (integrals.madelung_trunc(cell, kmesh, self.trunc)
                   if self.trunc is not None
                   else integrals.madelung(cell, kmesh))
            dmb = as_tensor(np.asarray(dm)[..., idx, :, :], vk_b.device,
                            vk_b.dtype)
            vk_b = add_ewald_exx(vk_b, s1e_b.to(vk_b.device, vk_b.dtype),
                                 dmb, mad)
        host = lambda t: to_numpy(t).astype(np.complex128, copy=False)
        out = (host(s1e_b), host(h1e_b), host(vj_b),
               host(vk_b) if vk_b is not None else 0.0)
        return out + (aob,) if return_ao else out

    def get_bands(self, kpts_band, dm=None):
        """Band energies and orbitals at arbitrary k-points from the
        converged density: F(kb) = hcore(kb) + J(kb) - K(kb)/2, one
        generalised eigensolve per point.  Returns (mo_energy list,
        mo_coeff list)."""
        dm = self.dm if dm is None else np.asarray(dm)
        if dm is None:
            raise ValueError("run kernel() first or pass dm")
        s1e_b, h1e_b, vj_b, vk_b = self._band_ingredients(kpts_band, dm)
        return self._eigh_bands(h1e_b + vj_b - 0.5 * vk_b, s1e_b)

    def _eigh_bands(self, fock, s1e_b):
        """(mo_energy list, mo_coeff list): one generalised eigensolve of
        ``fock`` (nb, nao, nao) per band point."""
        es, cs = [], []
        for kb in range(fock.shape[0]):
            e, c = _eigh_gen(fock[kb], s1e_b[kb], cutoff=self.ovlp_cutoff)
            es.append(e)
            cs.append(c)
        return es, cs


class KUHF(KRHF):
    """Unrestricted HF: dm has a spin axis (2, nk, nao, nao).

    J couples to the total density, K acts per spin.  ``init_spin``
    {atom_index: +1/-1} biases on-site levels per spin in the initial guess
    and in the Fock of the first ``bias_cycles`` cycles (AFM symmetry
    breaking); a caller-provided ``dm0`` skips the bias."""

    def __init__(self, cell, kpts, with_df=None, init_spin=None, spin_bias=0.5,
                 bias_cycles=4, **kw):
        self.init_spin = dict(init_spin or {})
        self.spin_bias = spin_bias
        self.bias_cycles = bias_cycles
        super().__init__(cell, kpts, with_df, **kw)

    def _atom_blocks(self):
        off = 0
        blocks = []
        for sym, _ in self.cell.atom:
            nfa = sum(sh.nfunc for sh in self.cell._basis[sym])
            blocks.append((off, nfa))
            off += nfa
        return blocks

    def _bias_matrices(self):
        """The on-site level shifts (2, nk, nao, nao): -/+ spin_bias
        init_spin[atom] S_k on each biased atom's block, spin up/down."""
        bias = np.zeros((2,) + self.s1e.shape, dtype=np.complex128)
        for ia, (off, nfa) in enumerate(self._atom_blocks()):
            b = self.init_spin.get(ia, 0.0)
            if b == 0.0:
                continue
            blk = self.s1e[:, off:off + nfa, off:off + nfa]
            for s, sgn in ((0, -1.0), (1, +1.0)):
                bias[s, :, off:off + nfa, off:off + nfa] += (
                    sgn * self.spin_bias * b * blk)
        return bias

    def _apply_bias(self, fock):
        """Spin-dependent on-site level shifts (AFM symmetry breaking)."""
        if not self.init_spin:
            return fock
        return fock + self._bias_matrices()

    @property
    def nocc_ab(self):
        ne = self.cell.nelectron
        na = (ne + self.cell.spin) // 2
        return na, ne - na

    def get_init_guess(self):
        nk = self.h1e.shape[0]
        bias = self._bias_matrices()
        dms = []
        for ispin, nocc in enumerate(self.nocc_ab):
            h = self.h1e + bias[ispin]
            es, cs = [], []
            for k in range(nk):
                e, c = _eigh_gen(h[k], self.s1e[k], cutoff=self.ovlp_cutoff)
                es.append(e)
                cs.append(c)
            occs = fixed_occupations(es, nocc, factor=1.0)
            dms.append(_build_dm(np.asarray(cs), np.asarray(occs)))
        return np.asarray(dms)

    def get_fock(self, dm):
        vj, vk = self._jk(dm)                  # (2, nk, nao, nao)
        vj_tot = vj[0] + vj[1]
        fock = np.stack([self.h1e + vj_tot - vk[0],
                         self.h1e + vj_tot - vk[1]])
        return fock, vj, vk

    def energy_elec(self, dm, vj, vk):
        nk = len(self.kpts)
        vj_tot = vj[0] + vj[1]
        e1 = np.einsum("skmn,knm->", dm, self.h1e).real / nk
        ecoul = 0.5 * np.einsum("skmn,knm->", dm, vj_tot).real / nk
        ex = -0.5 * np.einsum("skmn,sknm->", dm, vk).real / nk
        return e1 + ecoul + ex

    def _solve_fock(self, fock):
        """Per-spin generalised eigensolves of ``fock`` (2, nk, nao, nao)
        and their occupations: ``(es, cs, occs, dm, entropy, mus)``, with
        a chemical potential per spin when smearing is on."""
        nk = fock.shape[1]
        es, cs, occs, mus = [], [], [], []
        dm = np.empty_like(fock)
        entropy = 0.0
        for s, nocc in enumerate(self.nocc_ab):
            es_s, cs_s = [], []
            for k in range(nk):
                e, c = _eigh_gen(fock[s, k], self.s1e[k],
                                 cutoff=self.ovlp_cutoff)
                es_s.append(e)
                cs_s.append(c)
            if self.smearing > 0:
                occ_s, mu_s, ent_s = smeared_occupations(
                    es_s, nocc, self.smearing, self.smearing_method,
                    factor=1.0)
                entropy += ent_s
                mus.append(mu_s)
            else:
                occ_s = fixed_occupations(es_s, nocc, factor=1.0)
            dm[s] = _build_dm(np.asarray(cs_s), np.asarray(occ_s))
            es.append(es_s)
            cs.append(cs_s)
            occs.append(occ_s)
        return es, cs, occs, dm, entropy, mus

    def kernel(self, dm0=None):
        log = self._log
        dm = self.get_init_guess() if dm0 is None else np.asarray(dm0)
        # the bias steers the guess into the requested magnetic order; a
        # provided density already encodes its basin
        bias_cycles = self.bias_cycles if dm0 is None else 0
        diis = DIIS(self.diis_space, adiis_switch=self.adiis_switch)
        nk = self.h1e.shape[0]
        e_last = 0.0
        it = -1
        self.cycle_seconds = []
        for it in range(self.max_cycle):
            t0 = time.perf_counter()
            fock, vj, vk = self.get_fock(dm)
            e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
            err = np.stack([
                fock[s, k] @ dm[s, k] @ self.s1e[k]
                - self.s1e[k] @ dm[s, k] @ fock[s, k]
                for s in range(2) for k in range(nk)])
            # CDIIS only while the bias drives the Fock: ADIIS over biased
            # iterates averages the broken-symmetry seed away
            dm_for_adiis = (dm.reshape(-1)
                            if (not self.init_spin or it >= bias_cycles)
                            else None)
            fock = diis.update(fock.reshape(-1), err.reshape(-1),
                               dm_flat=dm_for_adiis).reshape(fock.shape)
            if it < bias_cycles:
                fock = self._apply_bias(fock)
            if self.level_shift:
                fock = fock + self.level_shift * np.stack([
                    np.stack([self.s1e[k]
                              - self.s1e[k] @ dm[sp, k] @ self.s1e[k]
                              for k in range(nk)])
                    for sp in range(2)])
            es, cs, occs, dm_new, self.entropy, mus = self._solve_fock(fock)
            if mus:
                self.mu = tuple(mus)
            if self.damp:
                dm_new = (1.0 - self.damp) * dm_new + self.damp * dm
            ddm = abs(dm_new - dm).max()
            de = abs(e_tot - e_last)
            self.cycle_seconds.append(time.perf_counter() - t0)
            log.info("UHF it %2d  E = %.10f  dE = %.2e  |ddm| = %.2e (%.2fs)",
                     it, e_tot, de, ddm, self.cycle_seconds[-1])
            dm = dm_new
            e_last = e_tot
            if de < self.conv_tol and ddm < np.sqrt(self.conv_tol):
                self.converged = True
                break
        self.cycles = it + 1
        fock, vj, vk = self.get_fock(dm)
        self.e_tot = self.energy_elec(dm, vj, vk) + self.e_nuc
        self.e_free = self.e_tot - self.smearing * self.entropy / nk
        self.mo_energy = np.asarray(es)
        self.mo_coeff = np.asarray(cs)
        self.mo_occ = np.asarray(occs)
        self.dm = dm
        return self.e_tot

    def get_bands(self, kpts_band, dm=None):
        """Per-spin band energies and orbitals at arbitrary k-points:
        F_s(kb) = hcore(kb) + J_tot(kb) - K_s(kb).  Returns (mo_energy
        [2][nb] lists, mo_coeff [2][nb] lists)."""
        dm = self.dm if dm is None else np.asarray(dm)
        if dm is None:
            raise ValueError("run kernel() first or pass dm")
        s1e_b, h1e_b, vj_b, vk_b = self._band_ingredients(kpts_band, dm)
        vj_tot = vj_b[0] + vj_b[1]
        es, cs = [], []
        for s in range(2):
            es_s, cs_s = self._eigh_bands(h1e_b + vj_tot - vk_b[s], s1e_b)
            es.append(es_s)
            cs.append(cs_s)
        return es, cs
