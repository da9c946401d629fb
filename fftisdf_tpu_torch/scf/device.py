"""Device-resident SCF loop: the whole iteration on the card.

Counterpart of ``fftisdf_tpu/scf/device.py``.  The host loops of
``scf.hf`` move vj/vk/fock/dm between the card and the host every cycle
and run the per-k algebra in numpy.  This loop keeps the iteration on
the J/K provider's device: J/K, Fock assembly, DIIS (a ring buffer and a
small complex solve, ADIIS by mirror descent), the batched
canonical-orthogonalisation eigensolve, smeared or aufbau occupations
(90-step chemical-potential bisection), the density update and the
energy.  The ADIIS descent and the bisection of both spins are one kernel
launch each on the card (``ops.scf_loops``).  Each cycle fetches one
small real vector (E, |ddm|, S) and nothing else; the batched
``torch.linalg.eigh`` also waits on the device once a cycle to check its
result.

Scope: KUHF/KRHF with fixed or smeared occupations, the AFM on-site bias
and linear density damping (``damp``); ``level_shift`` stays with the
host loop, and ``exxdiv`` is refused (the loop serves exxdiv=None).  The
Fock build of a cycle is a hook that ``scf.ks`` overrides for
DeviceKUKS/DeviceKRKS.
The loop runs in the SCF object's ``dtype`` (float64 unless float32 is
asked for); J/K are served in the provider's own precision and cast.  A
float32 loop's energy reduction is float32-granular (~6e-5 Ha at
|E| ~ 340), so the converged energy and orbitals are recomputed once on
the host in f64 either way.

Spans (``utils.profiling``, recorded only while it is on): ``scf.kernel``
› ``scf.prepare`` (the bases, the metric, the guess), one ``scf.cycle``
per cycle (› ``scf.jk``, ``scf.xc`` in the KS drivers, ``scf.diis`` ›
``scf.cdiis``/``scf.adiis``, ``scf.eigh``, ``scf.occ``, ``scf.fetch``)
and ``scf.finish`` (the host f64 recompute); the counter
``scf.adiis_taken`` (cycles that took ADIIS, read from the vector each
cycle fetches anyway; the ``scf.adiis`` spans count those that computed
it).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from fftisdf_tpu_torch.isdf import jk as jk_mod
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.ops import scf_loops
from fftisdf_tpu_torch.scf import core
from fftisdf_tpu_torch.scf.hf import KUHF, _eigh_gen
from fftisdf_tpu_torch.utils import profiling
from fftisdf_tpu_torch.utils.device import as_tensor, real_complex, to_numpy

# Dropped (near-null) overlap directions keep their column, which is zero
# in the orthogonalisation basis X, so they are exactly decoupled in
# X^H F X.  Each gets a diagonal entry above the spectrum, so it is never
# occupied.  The entry is scaled to the matrix's own norm (twice its largest
# absolute row sum, plus one): an eigensolver's backward error is
# eps ||A||, and a fixed 1e6 would put 0.06 Ha of it into every float32
# eigenvalue.  The eigensolve sorts the entries to the top of each
# spectrum, so the validity mask comes from the eigenvalues (below a gate
# between the row-sum bound and the entry), never from column positions.
# ``orth_and_penalty`` marks the dropped columns with a positive number.
_PENALTY = 1e6


def orth_and_penalty(s1e, cutoff):
    """Canonical orthogonalisation bases X_k with static shapes (host, f64).
    Returns (x (nk, nao, nao), penalty (nk, nao))."""
    nk, nao = s1e.shape[:2]
    x = np.zeros((nk, nao, nao), dtype=np.complex128)
    pen = np.zeros((nk, nao))
    for k in range(nk):
        se, sv = np.linalg.eigh(s1e[k])
        keep = se > cutoff * se.max()
        x[k] = sv * np.where(keep, 1.0 / np.sqrt(np.where(keep, se, 1.0)),
                             0.0)
        pen[k] = np.where(keep, 0.0, _PENALTY)
    return x, pen


def _diis_update(errs, focks, dms, ok, n, err, fock, dm, adiis_switch,
                 allow_adiis):
    """Store one (error, fock, density) row in the ring buffer and return
    ``(extrapolated fock (L,), n + 1, ADIIS taken)``.

    errs/focks/dms: (m, L) complex tensors and ok: (m,) bool tensor (the
    slot may enter the ADIIS hull), all written in place; n: rows stored
    so far.  The extrapolation is ``scf.core``'s: ADIIS while
    |FDS - SDF| > ``adiis_switch`` (chosen on the device, no fetch), CDIIS
    after.  Rows stored while ``allow_adiis`` was False (bias cycles)
    never enter the ADIIS hull, as in the host DIIS.  Nothing is copied
    from the host: the masks are made on the device.  The third value is
    the bool tensor "ADIIS taken", None where ADIIS was not computed."""
    m = errs.shape[0]
    idx = n % m
    errs[idx] = err
    focks[idx] = fock
    dms[idx] = dm
    ok[idx] = bool(allow_adiis)
    n += 1
    with profiling.span("scf.cdiis"):
        live = torch.arange(m, device=errs.device) < n
        fock_c = core.diis_extrapolate(errs, focks, live)
    if adiis_switch > 0.0 and allow_adiis:
        with profiling.span("scf.adiis"):
            hull = live & ok
            c_a = core.adiis_coeffs(dms, focks, idx, hull)
            fock_a = c_a.to(focks.dtype) @ focks
            use_a = (err.abs().max() > adiis_switch) & (hull.sum() >= 2)
            return torch.where(use_a, fock_a, fock_c), n, use_a
    return fock_c, n, None


class DeviceKUHF(KUHF):
    """KUHF with the device-resident iteration (one fetch per cycle) on
    the device of its FFTISDF J/K provider.  Same arguments and results
    as :class:`~fftisdf_tpu_torch.scf.hf.KUHF`; ``cycle_times`` holds the
    wall seconds of each cycle.

    The Fock build and energy of a cycle are three hooks, which the KS
    drivers (``scf.ks``) override: :meth:`_veff_args` (the extra device
    tensors the build reads), :meth:`_needs_exx` (whether it builds exact
    exchange, and so reads the image-space metric) and
    :meth:`_trace_veff`."""

    def _veff_args(self):
        """Extra device tensors :meth:`_trace_veff` reads, made once."""
        return ()

    def _needs_exx(self):
        """Whether :meth:`_trace_veff` builds exact exchange.  Only then is
        the image-space metric ``ws`` fetched (or built)."""
        return True

    def _trace_veff(self, dm, x_k, w0, ws, h1e):
        """(fock (2, nk, nao, nao), e_elec) of the UHF functional on the
        device.  J and K are served in the provider's precision from w0 =
        wq[0] and the image-space metric ``ws`` (the full wq is never
        read; on a mesh-sharded provider ``ws`` is the rank's image block
        and vk is summed over the ranks), then cast to the loop's."""
        nk = h1e.shape[0]
        cdt = h1e.dtype
        dm_s = dm.to(x_k.dtype)       # the provider's precision
        with profiling.span("scf.jk"):
            vj = jk_mod.get_j_kpts(x_k, w0, dm_s).to(cdt)
            vk = jk_mod.get_k_kpts_img(
                x_k, ws, dm_s, self._kmesh, phase_cs=self._phase_cs,
                mesh=getattr(self.with_df, "dev_mesh", None)).to(cdt)
        vj_tot = vj[0] + vj[1]
        fock = torch.stack([h1e + vj_tot - vk[0], h1e + vj_tot - vk[1]])
        dm_t = dm.transpose(-1, -2)
        e_elec = ((dm_t * h1e).sum().real / nk
                  + (dm_t * vj_tot).sum().real / (2 * nk)
                  - (dm_t * vk).sum().real / (2 * nk))
        return fock, e_elec

    def kernel(self, dm0=None):
        df = self.with_df
        if getattr(df, "x_k", None) is None:
            raise ValueError("DeviceKUHF needs a built FFTISDF J/K provider")
        if self.level_shift:
            raise NotImplementedError(
                "DeviceKUHF does not implement level_shift: use the host "
                "loop (scf.hf.KUHF) or smearing, the small-gap tool")
        if self.exxdiv is not None:
            raise NotImplementedError(
                f"exxdiv={self.exxdiv!r} in the device-resident loop: use "
                "the host loop (scf.hf.KUHF)")
        with profiling.span("scf.kernel"):
            return self._kernel(dm0)

    def _kernel(self, dm0):
        log = self._log
        df = self.with_df
        span = profiling.span
        with span("scf.prepare"):
            dev = df.device
            nk, nao = self.h1e.shape[:2]
            na, nb = self.nocc_ab
            rdt, cdt = real_complex(self.dtype)
            cplx = lambda a: as_tensor(a, dev, cdt)
            x_np, pen_np = orth_and_penalty(self.s1e, self.ovlp_cutoff)
            h1e, s1e, xo = cplx(self.h1e), cplx(self.s1e), cplx(x_np)
            xo_h = xo.mH
            dropped = torch.as_tensor(pen_np > 0, device=dev)
            bias = cplx(self._bias_matrices())
            self._kmesh = kpt_mod.kpts_to_kmesh(self.cell, self.kpts)
            # the serve reads w0 = wq[0] (a view) and, for exact exchange only,
            # the image-space metric; the full wq is never copied
            x_k, w0 = df.x_k, df.wq[0]
            ws = df.get_ws() if self._needs_exx() else None
            self._phase_cs = jk_mod._phase_cs(
                self._kmesh, real_complex(w0.dtype)[0], dev)
            veff_extra = self._veff_args()

            m = self.diis_space
            L = 2 * nk * nao * nao
            errs, focks, dms = (torch.zeros((m, L), dtype=cdt, device=dev)
                                for _ in range(3))
            ok = torch.zeros(m, dtype=torch.bool, device=dev)
            n = 0
            sigma = float(self.smearing)
            e_nuc = float(self.e_nuc)
            # a caller-provided density already encodes its magnetic basin:
            # the symmetry-breaking bias is for the initial guess only
            bias_cycles = int(self.bias_cycles) if dm0 is None else 0
            damp = float(self.damp)
            has_bias = bool(self.init_spin)
            # "ADIIS taken" of a cycle that did not compute ADIIS
            no_adiis = torch.zeros((), dtype=rdt, device=dev)
            no_entropy = torch.zeros((), dtype=rdt, device=dev)
            dm = cplx(self.get_init_guess() if dm0 is None else dm0)

        def step(dm, it):
            fock, e_elec = self._trace_veff(dm, x_k, w0, ws, h1e,
                                            *veff_extra)
            e_tot = e_elec + e_nuc
            err = fock @ dm @ s1e - s1e @ dm @ fock
            allow_adiis = (not has_bias) or it >= bias_cycles
            with span("scf.diis"):
                fock_x, n_new, use_a = _diis_update(
                    errs, focks, dms, ok, n, err.reshape(-1),
                    fock.reshape(-1), dm.reshape(-1),
                    float(self.adiis_switch), allow_adiis)
            fock = fock_x.reshape(fock.shape)
            if it < bias_cycles:
                fock = fock + bias
            with span("scf.eigh"):
                fo = xo_h @ fock @ xo
                bound = fo.abs().sum(dim=-1).amax(dim=-1, keepdim=True)
                pen = torch.where(dropped, 2.0 * bound + 1.0, 0.0)
                e, c = torch.linalg.eigh(fo + torch.diag_embed(pen).to(cdt))
                valid = e < 1.5 * bound + 0.5
            with span("scf.occ"):
                # penalised slots (valid False) get occupation 0
                if sigma > 0.0:
                    occ, ents, _ = scf_loops.smeared_bisect(
                        e, valid, (na * nk, nb * nk), sigma,
                        self.smearing_method)
                    ent = ents.sum()
                else:
                    occ = torch.stack([core.aufbau_occ(e[0], valid[0], na),
                                       core.aufbau_occ(e[1], valid[1], nb)])
                    ent = no_entropy
            mo = xo @ c
            dm_new = (mo * occ[:, :, None, :].to(cdt)) @ mo.mH
            if damp:
                dm_new = (1.0 - damp) * dm_new + damp * dm
            ddm = (dm_new - dm).abs().max()
            took = no_adiis if use_a is None else use_a.to(rdt)
            return dm_new, torch.stack([e_tot, ddm, ent, took]), n_new

        e_last, self.converged = 0.0, False
        it = -1
        self.cycle_times = []
        for it in range(self.max_cycle):
            with span("scf.cycle"):
                t0 = time.perf_counter()
                dm, stats, n = step(dm, it)
                with span("scf.fetch"):
                    e_tot, ddm, ent, took = (float(v) for v in stats.cpu())
                de = abs(e_tot - e_last)
                self.cycle_times.append(time.perf_counter() - t0)
            profiling.count("scf.adiis_taken", int(took))
            log.info("dSCF it %2d  E = %.10f  dE = %.2e  |ddm| = %.2e "
                     "(%.3fs)", it, e_tot, de, ddm, self.cycle_times[-1])
            e_last = e_tot
            self.entropy = ent
            if it > max(2, bias_cycles) and de < self.conv_tol \
                    and ddm < np.sqrt(self.conv_tol) * 30:
                self.converged = True
                break
        self.cycles = it + 1
        # the energy and orbitals of the converged density, once, on the
        # host in f64 (the attributes the host loop provides)
        with span("scf.finish"):
            self.dm = to_numpy(dm)
            fock, vj, vk = self.get_fock(self.dm)
            self.e_tot = float(self.energy_elec(self.dm, vj, vk)
                               + self.e_nuc)
            self.e_free = self.e_tot - sigma * self.entropy / nk
            es, cs, occs, _, _, mus = self._solve_fock(fock)
            self.mo_energy = np.asarray(es)
            self.mo_coeff = np.asarray(cs)
            self.mo_occ = np.asarray(occs)
            if mus:
                self.mu = tuple(mus)
        return self.e_tot


class DeviceKRHF(DeviceKUHF):
    """Restricted wrapper: the UHF step with na == nb, presenting
    RHF-convention results (spin-summed ``dm`` (nk, nao, nao), doubled
    ``mo_occ``).  For closed shells UHF and RHF coincide."""

    def __init__(self, cell, kpts, with_df=None, **kw):
        if cell.nelectron % 2:
            raise ValueError("odd electron count: use DeviceKUHF")
        super().__init__(cell, kpts, with_df, **kw)

    def kernel(self, dm0=None):
        if dm0 is not None and np.asarray(dm0).ndim == 3:
            dm0 = np.stack([np.asarray(dm0) / 2.0] * 2)
        e = super().kernel(dm0=dm0)
        self.dm = self.dm[0] + self.dm[1]
        self.mo_energy = self.mo_energy[0]
        self.mo_coeff = self.mo_coeff[0]
        self.mo_occ = 2.0 * self.mo_occ[0]
        return e

    def get_init_guess(self):
        nk = self.h1e.shape[0]
        occs, cs = [], []
        for k in range(nk):
            _, c = _eigh_gen(self.h1e[k], self.s1e[k],
                             cutoff=self.ovlp_cutoff)
            occ = np.zeros(c.shape[1])
            occ[: self.cell.nelectron // 2] = 1.0
            occs.append(occ)
            cs.append(c)
        dm1 = np.einsum("kmi,ki,kni->kmn", np.asarray(cs), np.asarray(occs),
                        np.conj(cs))
        return np.stack([dm1, dm1])
