"""k-point Kohn-Sham DFT (KRKS / KUKS) on the GPW grid.

Counterpart of ``fftisdf_tpu/scf/ks.py``.  The J/K provider of ``scf.hf``
serves the Hartree term (and, for hybrids, the exact exchange from the
same ISDF state), and the xc term is evaluated on the uniform grid by
``scf.xc``, its potential the autograd gradient of the discrete Exc.

Energy functional (restricted; nk = number of k-points):

    E = Tr(D h)/nk + 1/2 Tr(D J)/nk + Exc[rho] - hyb/4 Tr(D K)/nk + E_nuc

Fock: F = h + J + Vxc - hyb/2 K (per spin for KUKS, with J of the total
density and K per spin, unscaled by the 1/2).  A screened hybrid (HSE06)
adds its erfc-screened exchange at ``hyb_sr`` the same way.  ``hubbard``
adds DFT+U (``scf.hubbard``).

:class:`DeviceKUKS` and :class:`DeviceKRKS` run the device-resident loop
of ``scf.device`` with the KS functional in its step; pure functionals
never build K there, nor the image-space metric it reads.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.isdf import jk as jk_mod
from fftisdf_tpu_torch.scf import hubbard as hub_mod
from fftisdf_tpu_torch.scf import xc as xc_mod
from fftisdf_tpu_torch.scf.device import DeviceKRHF, DeviceKUHF
from fftisdf_tpu_torch.scf.hf import KRHF, KUHF
from fftisdf_tpu_torch.utils import profiling
from fftisdf_tpu_torch.utils.device import as_tensor, real_complex, to_numpy


def _host(t):
    return to_numpy(t).astype(np.complex128, copy=False)


class _KSCommon:
    """KS plumbing mixed into the HF drivers: ``xc`` names the functional
    (``scf.xc`` registry; 'hf' reduces to Hartree-Fock) and ``hubbard``
    ({atom_index: (l, U_hartree)}) turns on DFT+U."""

    def __init__(self, cell, kpts, with_df=None, xc="pbe", hubbard=None,
                 **kw):
        self.xc = xc
        self.hubbard = hubbard
        super().__init__(cell, kpts, with_df, **kw)
        self._ks_setup()

    def _keeps_ao(self):
        # every cycle's xc pass reads the full-grid AO tensor
        return bool(xc_mod.parse_xc(self.xc).terms)

    def _ks_setup(self):
        self._spec = xc_mod.parse_xc(self.xc)
        cell = self.cell
        self._fmesh = tuple(int(m) for m in cell.mesh)
        self._xc_weight = float(cell.vol) / int(np.prod(self._fmesh))
        rdt = self.dtype
        self._gv = torch.as_tensor(cell.get_Gv(self._fmesh), dtype=rdt,
                                   device=self.device)
        self._coords = self._kpts_arr = None
        if self._spec.is_mgga:
            # tau needs the Bloch AO gradients
            self._coords = torch.as_tensor(
                cell.gen_uniform_grids(self._fmesh), dtype=rdt,
                device=self.device)
            self._kpts_arr = torch.as_tensor(np.asarray(self.kpts),
                                             dtype=rdt, device=self.device)
        self._hub_sites = self._shalf = None
        if self.hubbard:
            self._hub_sites = hub_mod.build_sites(cell, self.hubbard)
            self._shalf = hub_mod.shalf_kpts(self.s1e)
        self._exc_last = 0.0
        self._eu_last = 0.0

    def _hubbard_eu_vu(self, dm_spin):
        """(E_U, V_U (nspin, nk, nao, nao)) of a spin-resolved host dm;
        (0.0, 0.0) when DFT+U is off."""
        if self._hub_sites is None:
            return 0.0, 0.0
        eu, vu, _g = hub_mod.eu_and_vu(dm_spin, self._shalf, self._hub_sites)
        return eu, vu

    def _hubbard_vu_bands(self, dm_spin, s1e_b):
        """V_U at band k-points from the mesh density's occupations."""
        _, _, g = hub_mod.eu_and_vu(dm_spin, self._shalf, self._hub_sites)
        return hub_mod.vu_from_g(hub_mod.shalf_kpts(s1e_b), g)

    def _dm_device(self, dm):
        return as_tensor(np.asarray(dm), self.device,
                         real_complex(self.dtype)[1])

    def _xc_eval(self, dm_dev, nspin):
        """(exc, Vxc (nspin, nk, nao, nao) on the host, nelec) in one
        device pass streamed over k-blocks (``scf.xc.xc_pass``, which does
        the work of the JAX package's ``_spin_rho``, ``_spin_tau``,
        ``_xc_rho_tau`` and ``_xc_fock_kernel``); a meta-GGA's matrices
        carry the generalised-KS tau term (weight/2) sum_i
        <grad_i phi | v_tau | grad_i phi>."""
        if not self._spec.terms:             # pure exact exchange
            nk, nao = self.h1e.shape[:2]
            return 0.0, np.zeros((nspin, nk, nao, nao), np.complex128), \
                float(self.cell.nelectron)
        exc, vxc, nelec, _, _ = xc_mod.xc_pass(
            self._get_ao(), dm_dev, self._gv, self._spec, self._fmesh,
            self._xc_weight, len(self.kpts), nspin, coords=self._coords,
            kpts=self._kpts_arr)
        return float(exc), _host(vxc), float(nelec)

    def _band_vxc(self, dm_dev, aob, nspin, kpts_band=None):
        """Vxc matrices (nspin, nb, nao, nao) at the band k-points of the
        AO tensor ``aob``: the mesh density's potential against their
        AOs (the JAX package's ``_xc_pot_kernel`` and
        ``_band_vxc_kernel``)."""
        nb, nao = aob.shape[0], aob.shape[2]
        if not self._spec.terms:
            return np.zeros((nspin, nb, nao, nao), np.complex128)
        _, _, _, v, vt = xc_mod.xc_pass(
            self._get_ao(), dm_dev, self._gv, self._spec, self._fmesh,
            self._xc_weight, len(self.kpts), nspin, coords=self._coords,
            kpts=self._kpts_arr, matrices=False)
        kb = None
        if vt is not None:
            kb = torch.as_tensor(np.asarray(kpts_band).reshape(-1, 3),
                                 dtype=self._gv.dtype, device=self.device)
        return _host(xc_mod.band_vxc(aob, v, self._xc_weight, vt=vt,
                                     kpts_b=kb, coords=self._coords,
                                     gv=self._gv, fmesh=self._fmesh))

    def _exx_matrices(self, dm_dev):
        """(vj, vk_eff) on the host: the Hartree matrix and the
        functional's total scaled exact exchange ``hyb*K + hyb_sr*
        K_SR(omega)`` (zeros for pure functionals).  The Fock term is then
        ``-0.5*vk_eff`` (restricted) or ``-vk_eff[s]`` (unrestricted) for
        global and screened hybrids alike.  The erfc-screened exchange
        (omega < 0, ``linalg.coulomb``'s convention) is finite at q+G = 0,
        so no exxdiv correction applies to it."""
        spec = self._spec
        need_k = spec.hyb != 0.0
        vj, vk = self.with_df.get_jk(dm_dev, with_k=need_k,
                                     exxdiv=self.exxdiv if need_k else None)
        vj = _host(vj)
        vk_eff = spec.hyb * _host(vk) if need_k else np.zeros_like(vj)
        if spec.hyb_sr != 0.0:
            _, vk_sr = self.with_df.get_jk(dm_dev, with_j=False,
                                           omega=-spec.omega)
            vk_eff = vk_eff + spec.hyb_sr * _host(vk_sr)
        return vj, vk_eff

    def _band_k_sr(self, kpts_band, dm, aob, omega):
        """erfc-screened exact exchange at band k-points by the exact
        plane-wave (band, mesh) pair sweep: the short-range kernel is
        finite at q+G = 0, so no argmin exclusion or exxdiv applies.
        Serves screened hybrids' band structures (HSE06 gaps)."""
        from fftisdf_tpu_torch.pw import jk as pw_jk

        kpts_band = np.asarray(kpts_band, dtype=np.float64).reshape(-1, 3)
        coords = self.cell.gen_uniform_grids()
        ao = self._get_ao()
        dmt = as_tensor(np.asarray(dm), ao.device, ao.dtype)
        kw = dict(coords=coords, ao_band=aob, kpts_band=kpts_band,
                  omega=omega, trunc=self.trunc)
        if dmt.ndim == 4:
            vk = torch.stack([pw_jk.get_k_kpts(self.cell, d, ao, self.kpts,
                                               **kw) for d in dmt])
        else:
            vk = pw_jk.get_k_kpts(self.cell, dmt, ao, self.kpts, **kw)
        return _host(vk)

    def _band_parts(self, kpts_band, dm):
        """(s1e_b, h1e_b, vj_b, vk_eff_b | None, aob) at band k-points."""
        spec = self._spec
        s1e_b, h1e_b, vj_b, vk_b, aob = self._band_ingredients(
            kpts_band, dm, with_k=spec.hyb != 0.0, return_ao=True)
        vk_eff_b = spec.hyb * vk_b if spec.hyb != 0.0 else None
        if spec.hyb_sr != 0.0:
            vk_sr = spec.hyb_sr * self._band_k_sr(kpts_band, dm, aob,
                                                  -spec.omega)
            vk_eff_b = vk_sr if vk_eff_b is None else vk_eff_b + vk_sr
        return s1e_b, h1e_b, vj_b, vk_eff_b, aob


class KRKS(_KSCommon, KRHF):
    """Restricted KS-DFT over a uniform k-mesh.  ``xc`` selects the
    functional ('lda', 'pbe', 'pbe0', 'b3lyp', 'scan', 'hse06', ...; 'hf'
    reduces exactly to KRHF); ``hubbard`` enables DFT+U:
    {atom_index: (l, U_hartree)} (``scf.hubbard``, Dudarev).  The other
    arguments are :class:`~fftisdf_tpu_torch.scf.hf.KRHF`'s."""

    def get_fock(self, dm):
        dm_dev = self._dm_device(dm)
        vj, vk_eff = self._exx_matrices(dm_dev)
        exc, vxc, _ = self._xc_eval(dm_dev[None], nspin=1)
        self._exc_last = exc
        dm = np.asarray(dm)
        eu, vu = self._hubbard_eu_vu(np.stack([dm, dm]) * 0.5)
        self._eu_last = eu
        fock = self.h1e + vj + vxc[0] - 0.5 * vk_eff
        if self._hub_sites is not None:
            fock = fock + vu[0]
        return fock, vj, vk_eff

    def energy_elec(self, dm, vj, vk_eff):
        nk = len(self.kpts)
        e1 = np.einsum("kmn,knm->", dm, self.h1e).real / nk
        ej = 0.5 * np.einsum("kmn,knm->", dm, vj).real / nk
        ex = -0.25 * np.einsum("kmn,knm->", dm, vk_eff).real / nk
        return e1 + ej + ex + self._exc_last + self._eu_last

    def get_bands(self, kpts_band, dm=None):
        """KS band energies F(kb) = h(kb) + J(kb) + Vxc(kb) - hyb/2 K(kb),
        with Vxc of the converged mesh density taken against the
        band-point AOs (the potential itself is k-independent).  Returns
        (mo_energy list, mo_coeff list)."""
        dm = self.dm if dm is None else np.asarray(dm)
        if dm is None:
            raise ValueError("run kernel() first or pass dm")
        s1e_b, h1e_b, vj_b, vk_eff_b, aob = self._band_parts(kpts_band, dm)
        vxc_b = self._band_vxc(self._dm_device(dm)[None], aob, nspin=1,
                               kpts_band=kpts_band)
        fock = h1e_b + vj_b + vxc_b[0]
        if vk_eff_b is not None:
            fock = fock - 0.5 * vk_eff_b
        if self._hub_sites is not None:
            fock = fock + self._hubbard_vu_bands(
                np.stack([dm, dm]) * 0.5, s1e_b)[0]
        return self._eigh_bands(fock, s1e_b)


class KUKS(_KSCommon, KUHF):
    """Unrestricted KS-DFT: dm (2, nk, nao, nao); J of the total density,
    per-spin Vxc, per-spin exact exchange at the hybrid fraction.
    ``hubbard`` enables DFT+U with per-spin occupation matrices: what
    holds the AFM order of NiO.  The other arguments are
    :class:`~fftisdf_tpu_torch.scf.hf.KUHF`'s."""

    def get_fock(self, dm):
        dm_dev = self._dm_device(dm)
        vj, vk_eff = self._exx_matrices(dm_dev)
        exc, vxc, _ = self._xc_eval(dm_dev, nspin=2)
        self._exc_last = exc
        eu, vu = self._hubbard_eu_vu(np.asarray(dm))
        self._eu_last = eu
        vj_tot = vj[0] + vj[1]
        fock = np.stack([self.h1e + vj_tot + vxc[0] - vk_eff[0],
                         self.h1e + vj_tot + vxc[1] - vk_eff[1]])
        if self._hub_sites is not None:
            fock = fock + vu
        return fock, vj, vk_eff

    def energy_elec(self, dm, vj, vk_eff):
        nk = len(self.kpts)
        vj_tot = vj[0] + vj[1]
        e1 = np.einsum("skmn,knm->", dm, self.h1e).real / nk
        ej = 0.5 * np.einsum("skmn,knm->", dm, vj_tot).real / nk
        ex = -0.5 * np.einsum("skmn,sknm->", dm, vk_eff).real / nk
        return e1 + ej + ex + self._exc_last + self._eu_last

    def get_bands(self, kpts_band, dm=None):
        """Per-spin KS band energies and orbitals at arbitrary k-points:
        (mo_energy [2][nb] lists, mo_coeff [2][nb] lists)."""
        dm = self.dm if dm is None else np.asarray(dm)
        if dm is None:
            raise ValueError("run kernel() first or pass dm")
        s1e_b, h1e_b, vj_b, vk_eff_b, aob = self._band_parts(kpts_band, dm)
        vxc_b = self._band_vxc(self._dm_device(dm), aob, nspin=2,
                               kpts_band=kpts_band)
        vu_b = (self._hubbard_vu_bands(dm, s1e_b)
                if self._hub_sites is not None else None)
        vj_tot = vj_b[0] + vj_b[1]
        es, cs = [], []
        for s in range(2):
            fock = h1e_b + vj_tot + vxc_b[s]
            if vk_eff_b is not None:
                fock = fock - vk_eff_b[s]
            if vu_b is not None:
                fock = fock + vu_b[s]
            es_s, cs_s = self._eigh_bands(fock, s1e_b)
            es.append(es_s)
            cs.append(cs_s)
        return es, cs


# ----------------------------------------------------------------------
# the device-resident loop of scf.device with the KS functional in its step

class _DeviceKSVeff:
    """KS Fock build of the device-resident loop: ISDF Hartree + the grid
    xc pass, exact exchange only at the hybrid fraction.  Pure functionals
    never build K nor fetch the image-space metric, which removes the most
    expensive part of the serve from every DFT cycle."""

    def _needs_exx(self):
        # only the full-range K reads ws; a screened hybrid's short-range K
        # reads its own erfc metric from _veff_args
        return bool(self._spec.hyb)

    def _veff_args(self):
        extra = (self._get_ao(), self._gv)
        if self._spec.is_mgga:
            extra = extra + (self._coords, self._kpts_arr)
        if self._spec.hyb_sr:
            # the erfc-screened image-space metric (one extra metric pass a
            # build, cached on the provider)
            extra = extra + (self.with_df.get_ws_omega(-self._spec.omega),)
        if self._hub_sites is not None:
            extra = extra + (as_tensor(self._shalf, self.with_df.device,
                                       real_complex(self.dtype)[1]),)
        return extra

    def _trace_veff(self, dm, x_k, w0, ws, h1e, ao, gv, *extra):
        spec = self._spec
        coords = kpts_arr = shalf = ws_sr = None
        if spec.is_mgga:
            coords, kpts_arr, *extra = extra
        if spec.hyb_sr:
            ws_sr, *extra = extra
        if extra:
            (shalf,) = extra
        nk = h1e.shape[0]
        cdt = h1e.dtype
        dm_s = dm.to(x_k.dtype)       # the provider's precision
        with profiling.span("scf.jk"):
            vj = jk_mod.get_j_kpts(x_k, w0, dm_s).to(cdt)
        vj_tot = vj[0] + vj[1]
        with profiling.span("scf.xc"):
            exc, vxc, _, _, _ = xc_mod.xc_pass(
                ao, dm.to(ao.dtype), gv, spec, self._fmesh, self._xc_weight,
                nk, 2, coords=coords, kpts=kpts_arr)
            vxc = vxc.to(cdt)
        dm_t = dm.transpose(-1, -2)
        e1 = (dm_t * h1e).sum().real / nk
        ecoul = (dm_t * vj_tot).sum().real / (2 * nk)
        fock = torch.stack([h1e + vj_tot + vxc[0], h1e + vj_tot + vxc[1]])
        e_elec = e1 + ecoul + exc.to(e1.dtype)
        if spec.hyb or spec.hyb_sr:
            vk_eff = 0.0
            mesh = getattr(self.with_df, "dev_mesh", None)
            with profiling.span("scf.jk"):
                if spec.hyb:
                    vk_eff = spec.hyb * jk_mod.get_k_kpts_img(
                        x_k, ws, dm_s, self._kmesh,
                        phase_cs=self._phase_cs, mesh=mesh).to(cdt)
                if spec.hyb_sr:
                    vk_eff = vk_eff + spec.hyb_sr * jk_mod.get_k_kpts_img(
                        x_k, ws_sr, dm_s, self._kmesh,
                        phase_cs=self._phase_cs, mesh=mesh).to(cdt)
            fock = fock - vk_eff
            e_elec = e_elec - 0.5 * (dm_t * vk_eff).sum().real / nk
        if shalf is not None:
            with profiling.span("scf.hubbard"):
                e_u, vu = hub_mod.eu_and_vu_traced(dm, shalf,
                                                   self._hub_sites)
            fock = fock + vu
            e_elec = e_elec + e_u
        return fock, e_elec


class DeviceKUKS(_DeviceKSVeff, KUKS, DeviceKUHF):
    """KUKS with the device-resident iteration loop."""


class DeviceKRKS(_DeviceKSVeff, KUKS, DeviceKRHF):
    """Restricted device KS: the spin-split device loop (the channels
    coincide for closed shells), presenting restricted results."""
