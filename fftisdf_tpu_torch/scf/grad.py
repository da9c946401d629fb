"""Analytic nuclear gradients (forces) for periodic KRHF/KUHF/KRKS/KUKS.

Counterpart of ``fftisdf_tpu/scf/grad.py``.  Every term of the total
energy -- Bloch AO evaluation, the FFT kinetic matrix, the GTH local and
nonlocal pseudopotential, Ewald, and the two-electron energy (exact plane
wave or frozen-point ISDF) -- is a torch function of the atom positions,
so the force vector is one reverse-mode sweep of

    L(R) = (1/nk) sum_k tr(D_k h_k(R)) + E_2e(R; D)
           - (1/nk) sum_k tr(W_k S_k(R)) + E_nn(R) + const,

the SCF Lagrangian at the converged density D and energy-weighted density
W_k = sum_i f_ki eps_ki c_ki c_ki^H (-tr(W dS) is the Pulay force; the
constant restores L(R0) = E_tot).  Valid at SCF stationarity with frozen
occupations (for a smeared SCF this is the Mermin free-energy force).

Two two-electron backends:
- 'pw':   the exact plane-wave J/K energy (``pw.jk``, the oracle path);
- 'isdf': the ISDF approximant at a frozen interpolation-point set
          (``isdf.autodiff.isdf_state_fn``): the exact derivative of the
          approximant.

The traced tensors live on the device of the ISDF state (``df.device``)
or of the SCF (``mf.device``): ``cuda`` unless the caller asks for the
CPU.  Each evaluation is an eager ``torch.autograd.grad`` of a closure that
holds the host-built constants (image lists, form factors, G vectors,
Ewald lists) of one lattice and is reused across geometries.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.isdf import jk as jkm
from fftisdf_tpu_torch.isdf.autodiff import isdf_state_fn, make_evaluator_diff
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.pw import jk as pw_jk
from fftisdf_tpu_torch.scf import integrals
from fftisdf_tpu_torch.scf import xc as xc_mod
from fftisdf_tpu_torch.utils.device import (as_tensor, real_complex,
                                            resolve_device)


def ewald_fn(cell, eta=None, dtype=None, *, device="cuda"):
    """Differentiable ion-ion Ewald energy: positions (natm, 3) -> 0-d
    tensor.  Same convention as ``scf.integrals.ewald``; the translation
    and G lists are frozen at the reference geometry.  The fixed-lattice
    slice of ``scf.stress.ewald_strain_fn``."""
    from fftisdf_tpu_torch.scf.stress import ewald_strain_fn

    device = resolve_device(device)
    rdt = real_complex(dtype)[0]
    e_strain = ewald_strain_fn(cell, dtype=rdt, eta=eta, device=device)
    a0 = np.asarray(cell.a)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=device)
    a0_t, a0inv = t(a0), t(np.linalg.inv(a0))
    frac0 = t(cell.atom_coords() @ np.linalg.inv(a0))

    def energy(positions):
        positions = torch.as_tensor(positions, dtype=rdt, device=device)
        return e_strain(a0_t, positions @ a0inv - frac0)

    return energy


def xc_setup(xc):
    """(spec or None, hyb, hyb_sr, omega_sr) of an ``xc`` name: None and
    'hf' are Hartree-Fock (hyb 1)."""
    if xc is None or str(xc).strip().lower() == "hf":
        return None, 1.0, 0.0, None
    spec = xc_mod.parse_xc(xc)
    hyb_sr = float(getattr(spec, "hyb_sr", 0.0))
    return spec, float(spec.hyb), hyb_sr, (float(spec.omega) if hyb_sr
                                          else None)


def exc_traced(spec, f_k, dm_spin, nk, gv, mesh, w, kpts=None, coords=None,
               angle=None):
    """Grid Exc of the traced AO density (and tau for a meta-GGA): the
    xc Pulay force comes from the same reverse sweep."""
    rho = ((f_k.unsqueeze(0) @ dm_spin) * f_k.conj().unsqueeze(0)).sum(
        dim=(1, 3)).real / nk
    tau = None
    if spec.is_mgga:
        dphi = xc_mod.bloch_ao_grad(f_k, kpts, coords, gv, mesh,
                                    angle=angle)
        tau = xc_mod.get_tau(dphi, dm_spin, nk)
    if not spec.terms:
        return rho.new_zeros(())
    return xc_mod._exc_total(rho, tau, gv, spec, mesh, w)


def _tr(a, b):
    """sum over k of Re tr(a_k b_k) for (..., nk, n, n) tensors."""
    return (a * b.transpose(-1, -2)).sum().real


def make_energy_fn(cell, kpts, dtype=None, two_electron="pw", mask=None,
                   m0=None, solver="ridge", rcond=1e-10, dev_mesh=None,
                   exxdiv=None, max_memory_gb=None, xc=None, hubbard=None,
                   *, device="cuda"):
    """Differentiable total-energy Lagrangian
    ``energy(positions, dm, wdm, w_trace) -> 0-d tensor``, dm (nk, nao,
    nao) [RHF] or (2, nk, nao, nao) [UHF], wdm the matching energy-weighted
    density, all tensors on ``device``.  ``two_electron='isdf'`` needs
    ``mask``/``m0`` of a prior FFTISDF build.

    ``exxdiv`` must match the Fock the density was converged with: for
    'ewald' the Madelung exchange -fac mad/nk sum_k tr(D S D S) is part of
    the functional.  ``xc`` switches to KS-DFT (exchange scaled by the
    hybrid fraction, grid Exc of the traced density added); ``hubbard``
    adds the Dudarev +U energy with occupations from the traced S(R)^1/2
    (``hubbard.sqrtm_traced``).  ``dev_mesh``: the ISDF state is built
    sharded over the mesh (``isdf_state_fn(dev_mesh=)``; ``device`` is the
    rank's); the rest of the Lagrangian runs on every rank alike, so each
    rank returns the same energy, and every rank must evaluate it (and its
    gradient) together."""
    if exxdiv not in (None, "ewald"):
        raise NotImplementedError(f"exxdiv={exxdiv!r} gradients")
    device = resolve_device(device)
    rdt, cdt = real_complex(dtype)
    spec, hyb, hyb_sr, omega = xc_setup(xc)
    omg_sr = -omega if hyb_sr else None
    hub_sites = None
    if hubbard:
        from fftisdf_tpu_torch.scf import hubbard as hub_mod
        hub_sites = hub_mod.build_sites(cell, hubbard)
    kpts = np.asarray(kpts)
    kmesh = kpt_mod.kpts_to_kmesh(cell, kpts)
    mad = (float(integrals.madelung(cell, kmesh)) if exxdiv == "ewald"
           else None)
    nk = len(kpts)
    coords = cell.gen_uniform_grids()
    ngrid = coords.shape[0]
    mesh = tuple(int(m) for m in cell.mesh)
    vol = float(cell.vol)
    w = vol / ngrid
    t = lambda a, dt=rdt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=device)
    fn_ao = make_evaluator_diff(cell, kpts=kpts, dtype=rdt, device=device)
    coords_t = t(coords)
    gv = cell.get_Gv(mesh)
    gv_t, kpts_t = t(gv), t(kpts)
    vG_atoms = t(integrals.vloc_form_factors(cell, gv))
    proj_shells, hmat = integrals._projector_shells(cell)
    fn_proj = (make_evaluator_diff(cell, kpts=kpts, dtype=rdt,
                                   shells=proj_shells, device=device)
               if proj_shells else None)
    hmat_t = t(hmat, cdt) if proj_shells else None
    e_nn = ewald_fn(cell, dtype=rdt, device=device)
    # kinetic phases e^{-ik.r} and |G+k|^2 / 2: position-free constants
    ang = coords @ kpts.T                                   # (ng, nk)
    kin_ph = torch.polar(torch.ones_like(t(ang)), -t(ang)).T  # (nk, ng)
    g2k = t(0.5 * np.stack([np.sum((gv + k) ** 2, axis=1) for k in kpts]))

    if two_electron == "isdf":
        assert mask is not None, "isdf backend needs the frozen mask"
        state = isdf_state_fn(cell, kpts, mask, m0=m0, solver=solver,
                              rcond=rcond, dtype=rdt,
                              max_memory_gb=max_memory_gb,
                              omegas=(omg_sr,) if hyb_sr else None,
                              dev_mesh=dev_mesh, device=device)
        ph = kpt_mod.get_phase(cell, kpts, kmesh)
        phase = torch.complex(t(ph.real), t(ph.imag))
    elif two_electron != "pw":
        raise ValueError(two_electron)

    def hcore_and_ovlp(positions, f_k):
        s = w * (f_k.mH @ f_k)
        c = fft3((f_k * kin_ph[:, :, None]).transpose(1, 2), mesh) / ngrid
        tmat = vol * ((c.conj() * g2k[:, None, :]) @ c.transpose(1, 2))
        gp = gv_t @ positions.T                             # (ng, natm)
        fr = (torch.cos(gp) * vG_atoms.T).sum(dim=1)
        fi = -(torch.sin(gp) * vG_atoms.T).sum(dim=1)
        vgrid = ifft3(torch.complex(fr, fi), mesh).real * (ngrid / vol)
        vloc = w * (f_k.mH @ (vgrid[None, :, None] * f_k))
        h = tmat + vloc
        if fn_proj is not None:
            p_k = fn_proj(coords_t, positions)
            bmat = w * (p_k.mH @ f_k)
            h = h + bmat.mH @ hmat_t @ bmat
        return h, s

    def e2_pw(f_k, dm):
        def ek_term(dmat, fac):
            e = 0.0
            if hyb != 0.0:
                vk = pw_jk.get_k_kpts(cell, dmat, f_k, kpts)
                e = e - fac * hyb * _tr(dmat, vk) / nk
            if hyb_sr != 0.0:
                vk = pw_jk.get_k_kpts(cell, dmat, f_k, kpts, omega=omg_sr)
                e = e - fac * hyb_sr * _tr(dmat, vk) / nk
            return e

        if dm.ndim == 4:
            dm_tot = dm[0] + dm[1]
            vj = pw_jk.get_j_kpts(cell, dm_tot, f_k)
            return (0.5 * _tr(dm_tot, vj) / nk + ek_term(dm[0], 0.5)
                    + ek_term(dm[1], 0.5))
        vj = pw_jk.get_j_kpts(cell, dm, f_k)
        return 0.5 * _tr(dm, vj) / nk + ek_term(dm, 0.25)

    def e2_isdf(positions, dm):
        x_k, wq = state(positions)
        wq_sr = None
        if hyb_sr:
            wq, wq_sr = wq[0], wq[1]

        def ek_term(dm_s, fac):
            e = 0.0
            if hyb != 0.0:
                vk = jkm.get_k_kpts(x_k, wq, phase, dm_s)
                e = e - fac * hyb * _tr(dm_s, vk) / nk
            if hyb_sr != 0.0:
                vk = jkm.get_k_kpts(x_k, wq_sr, phase, dm_s)
                e = e - fac * hyb_sr * _tr(dm_s, vk) / nk
            return e

        dm_tot = dm[0] + dm[1] if dm.ndim == 4 else dm
        vj = jkm.get_j_kpts(x_k, wq[0], dm_tot[None])[0]
        ej = 0.5 * _tr(dm_tot, vj) / nk
        return ej + ek_term(dm if dm.ndim == 4 else dm[None],
                            0.5 if dm.ndim == 4 else 0.25)

    def energy(positions, dm, wdm, w_trace):
        f_k = fn_ao(coords_t, positions)
        h, s = hcore_and_ovlp(positions, f_k)
        dm_tot = dm[0] + dm[1] if dm.ndim == 4 else dm
        wdm_tot = wdm[0] + wdm[1] if wdm.ndim == 4 else wdm
        e1 = _tr(dm_tot, h) / nk
        e2 = (e2_isdf(positions, dm) if two_electron == "isdf"
              else e2_pw(f_k, dm))
        if mad is not None and hyb != 0.0:
            # exxdiv='ewald': vk += mad S D S per spin channel, with S(R)
            sds = s @ dm @ s
            fac = -0.5 if dm.ndim == 4 else -0.25
            e2 = e2 + fac * hyb * mad / nk * _tr(dm, sds)
        if spec is not None or hub_sites is not None:
            dm_spin = dm if dm.ndim == 4 else torch.stack([dm, dm]) * 0.5
        if spec is not None:
            e2 = e2 + exc_traced(spec, f_k, dm_spin, nk, gv_t, mesh, w,
                                 kpts=kpts_t, coords=coords_t)
        if hub_sites is not None:
            from fftisdf_tpu_torch.scf import hubbard as hub_mod
            e2 = e2 + hub_mod.eu_and_vu_traced(
                dm_spin, hub_mod.sqrtm_traced(s), hub_sites)[0]
        pulay = -_tr(wdm_tot, s) / nk
        return e1 + e2 + pulay + w_trace + e_nn(positions)

    return energy


def density_orbitals(mf):
    """(mo_energy, mo_coeff, mo_occ) of the Fock matrix of ``mf.dm``
    itself, with ``mf``'s occupations.

    A host SCF loop reports the orbitals of its last DIIS-extrapolated
    Fock, which mixes the Focks of earlier densities: warm-started at a new
    geometry (relaxation, MD, finite-difference Hessians), the first of
    them belongs to the previous geometry's density, and the orbital
    energies can sit 1e-3 Ha off those of the converged density, which
    puts an O(1e-4) Ha/bohr error into the Pulay term -tr(W dS).  The
    eigenpairs of F(D) are what W must hold (the device loop reports those
    already).  An object without ``get_fock`` (a recorded density) keeps
    its own orbitals."""
    if not hasattr(mf, "get_fock"):
        return mf.mo_energy, mf.mo_coeff, mf.mo_occ
    from fftisdf_tpu_torch.scf.hf import KUHF, _eigh_gen

    dm = np.asarray(mf.dm)
    if isinstance(mf, KUHF) and dm.ndim == 3:
        # DeviceKRHF / DeviceKRKS: restricted results of the spin-split
        # step; the Fock of either spin channel at half the density
        fock = np.asarray(mf.get_fock(np.stack([dm, dm]) * 0.5)[0])[0]
    else:
        fock = np.asarray(mf.get_fock(dm)[0])
    s1e = np.asarray(mf.s1e)
    cutoff = getattr(mf, "ovlp_cutoff", 1e-10)
    flat = fock.reshape(-1, *fock.shape[-2:])
    nk = s1e.shape[0]
    es, cs = [], []
    for i, f in enumerate(flat):
        e, c = _eigh_gen(f, s1e[i % nk], cutoff=cutoff)
        es.append(e)
        cs.append(c)
    shape = fock.shape[:-2]
    return (np.asarray(es).reshape(shape + (-1,)),
            np.asarray(cs).reshape(shape + cs[0].shape), mf.mo_occ)


def energy_weighted_dm(mf):
    """W_k = sum_i f_ki eps_ki c_ki c_ki^H of a converged SCF (host
    arrays), from the eigenpairs of the converged density's own Fock
    (:func:`density_orbitals`), and its trace constant
    sum_{k,i} f eps / nk (restores L(R0) = e_tot)."""
    mo_energy, mo_coeff, mo_occ = density_orbitals(mf)

    def one_spin(es, cs, occs):
        wk, tr = [], 0.0
        for e, c, f in zip(es, cs, occs):
            e, f, c = np.asarray(e), np.asarray(f), np.asarray(c)
            wk.append(np.einsum("mi,i,ni->mn", c, f * e, c.conj()))
            tr += float(np.sum(f * e))
        return np.asarray(wk), tr

    nk = len(mf.kpts)
    if np.asarray(mf.dm).ndim == 4:  # UHF
        wks, tr = [], 0.0
        for s in range(2):
            wk_s, tr_s = one_spin(mo_energy[s], mo_coeff[s], mo_occ[s])
            wks.append(wk_s)
            tr += tr_s
        return np.asarray(wks), tr / nk
    wk, tr = one_spin(mo_energy, mo_coeff, mo_occ)
    return wk, tr / nk


def _norm_xc(v):
    v = None if v is None else str(v).strip().lower()
    return None if v == "hf" else v


def check_functional(mf, xc, hubbard, exxdiv, what="gradient"):
    """ValueError unless ``mf`` was converged with the functional an
    evaluator traces: the density is only stationary for that one."""
    if _norm_xc(getattr(mf, "xc", None)) != _norm_xc(xc) or \
            getattr(mf, "hubbard", None) != hubbard:
        raise ValueError(
            f"mf was converged with xc={getattr(mf, 'xc', None)!r}/"
            f"hubbard={getattr(mf, 'hubbard', None)!r} but this {what} "
            f"evaluator traces xc={xc!r}/hubbard={hubbard!r}; the density "
            "is only stationary for the functional it was converged with")
    mf_ex = getattr(mf, "exxdiv", None)
    if mf_ex != exxdiv:
        raise ValueError(
            f"mf was converged with exxdiv={mf_ex!r} but this {what} "
            f"evaluator was built with exxdiv={exxdiv!r}; pass the matching "
            "exxdiv (the density is only stationary for the functional it "
            "was converged with)")


def scf_tensors(mf, device, cdt):
    """(dm, wdm, w_trace) of a converged SCF as tensors on ``device``."""
    wdm, w_trace = energy_weighted_dm(mf)
    return (as_tensor(np.asarray(mf.dm), device, cdt),
            as_tensor(wdm, device, cdt), w_trace)


def _device_of(df, device):
    if device is not None:
        return resolve_device(device)
    return df.device if df is not None else resolve_device("cuda")


def make_grad_fn(cell, kpts, two_electron="pw", df=None, dtype=None,
                 dev_mesh=None, exxdiv=None, max_memory_gb=None, xc=None,
                 hubbard=None, *, device=None):
    """A reusable gradient evaluator ``fn(mf) -> (grad (natm, 3), E)``,
    host arrays out.  The closure's constants belong to the given lattice,
    mesh and basis and serve every geometry of a sweep (the frozen image
    and translation lists are exact for sub-cell displacements); with
    ``two_electron='isdf'`` the mask of ``df`` stays frozen.  Runs on
    ``device`` (None: ``df.device``, else ``cuda``)."""
    if getattr(df, "trunc", None) is not None:
        raise NotImplementedError(
            "gradients with a truncated Coulomb kernel: the traced energy "
            "is the bare-kernel functional")
    device = _device_of(df, device)
    rdt, cdt = real_complex(dtype)
    kw = {}
    if two_electron == "isdf":
        assert df is not None and df.mask is not None
        kw = dict(mask=df.mask, m0=df.m0, solver=df.solver, rcond=df.rcond,
                  max_memory_gb=max_memory_gb)
    e_fn = make_energy_fn(cell, kpts, dtype=rdt, two_electron=two_electron,
                          exxdiv=exxdiv, xc=xc, hubbard=hubbard,
                          dev_mesh=dev_mesh, device=device, **kw)

    def fn(mf):
        assert getattr(mf, "dm", None) is not None, "run mf.kernel() first"
        check_functional(mf, xc, hubbard, exxdiv)
        dm, wdm, w_trace = scf_tensors(mf, device, cdt)
        pos = torch.as_tensor(np.asarray(mf.cell.atom_coords()), dtype=rdt,
                              device=device).requires_grad_(True)
        with torch.enable_grad():
            val = e_fn(pos, dm, wdm, w_trace)
            (g,) = torch.autograd.grad(val, pos)
        return g.detach().cpu().numpy(), float(val.detach())

    return fn


def kernel(mf, two_electron="pw", df=None, dtype=None, max_memory_gb=None):
    """Nuclear gradient dE/dR (natm, 3) and the Lagrangian value (== e_tot)
    of a converged KRHF/KUHF/KRKS/KUKS; forces are the negative.
    ``two_electron='isdf'`` differentiates the ISDF approximant of ``df``
    (a built FFTISDF) at its frozen interpolation points, on ``df``'s
    device; 'pw' the exact plane-wave energy, on ``mf.device``.
    ``mf.exxdiv``, ``mf.xc`` and ``mf.hubbard`` are honoured."""
    if getattr(mf, "trunc", None) is not None:
        raise NotImplementedError(
            "gradients with a truncated Coulomb kernel: the traced energy "
            "differentiates the bare-kernel functional, which the trunc "
            "density is not stationary for")
    device = df.device if df is not None else mf.device
    return make_grad_fn(mf.cell, mf.kpts, two_electron=two_electron, df=df,
                        dtype=dtype, exxdiv=getattr(mf, "exxdiv", None),
                        xc=getattr(mf, "xc", None),
                        hubbard=getattr(mf, "hubbard", None),
                        max_memory_gb=max_memory_gb, device=device)(mf)
