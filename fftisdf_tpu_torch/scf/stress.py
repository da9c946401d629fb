"""Analytic stress tensor for periodic KRHF/KUHF/KRKS/KUKS by reverse-mode
strain.

Counterpart of ``fftisdf_tpu/scf/stress.py``.  The lattice is traced
through a symmetric strain ``eps``: ``A = a0 @ (1 + eps)`` with atoms at
fixed fractional coordinates (plus optional fractional displacements
``dfrac``).  At SCF stationarity the strain derivative of the
frozen-density Lagrangian is the exact energy derivative, so

    sigma = (1/vol) dL/deps|_{eps=0},   P = -tr(sigma)/3 .

Every oscillatory phase is a product of an integer and a fractional
vector (r.k, T.k, G.r), so all phase tables are strain-invariant host
constants; only AO values, |G|-dependent kernels (kinetic |G+k|^2, Coulomb
4 pi/|q+G|^2, GTH form factors), volume measures and the Ewald vector lists
trace through ``eps``.  The FFTs are index transforms and never see the
strain.

Two-electron term: the exact plane-wave energy ('pw', pairwise Poisson
exchange), or the frozen-point ISDF approximant re-fitted under the
strain ('isdf').  At production sizes each exchange pair and each ISDF
sector is checkpointed (the sector with the fit-factor policy of
``isdf.autodiff``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fftisdf_tpu_torch.isdf import jk as jkm
from fftisdf_tpu_torch.isdf.autodiff import (DiffGroups, _blocked,
                                             _group_chi_diff, _remat,
                                             _rhs_full)
from fftisdf_tpu_torch.isdf.kpoint import _stripe_quartic
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.linalg.solvers import solve_fitting
from fftisdf_tpu_torch.scf import integrals
from fftisdf_tpu_torch.scf.grad import (_device_of, _tr, check_functional,
                                        exc_traced, scf_tensors, xc_setup)
from fftisdf_tpu_torch.utils.device import real_complex, resolve_device


def _strain_evaluator(cell, kpts, dtype, shells=None, frac_pts=None, *,
                      device="cuda"):
    """``eval_fn(A, positions) -> f_k (nk, ng, nfunc)`` with the lattice
    matrix A traced, at ``frac_pts`` (fractional, in [0, 1); default the
    full FFT grid).  Image lists and image phases are frozen at the
    reference lattice (exact for the infinitesimal strains of a
    derivative)."""
    device = resolve_device(device)
    rdt, _ = real_complex(dtype)
    tabs = DiffGroups(cell, cell.precision, shells, rdt, device)
    a0inv = np.linalg.inv(np.asarray(cell.a))
    kscaled = cell.get_scaled_kpts(np.asarray(kpts))
    frac = (cell.gen_uniform_grids() @ a0inv if frac_pts is None
            else np.asarray(frac_pts))
    assert np.all(frac > -1e-9) and np.all(frac < 1 + 1e-9)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=device)
    frac_t = t(frac)
    groups = []
    for specs, exps, images, ia in tabs.groups:
        ii = np.rint(images @ a0inv)
        tph = 2.0 * np.pi * ii @ kscaled.T                    # (T, nk)
        groups.append((specs, exps, t(ii), ia,
                       (t(np.cos(tph)), t(np.sin(tph)))))

    def block(fr, A, positions):
        coords = fr @ A
        out = []
        for specs, exps, ii, ia, ph in groups:
            chi = _group_chi_diff(coords, specs, exps,
                                  positions[ia][None, :] + ii @ A)
            chi_t = chi.transpose(1, 2)
            out.append(torch.complex((chi_t @ ph[0]).permute(2, 0, 1),
                                     (chi_t @ ph[1]).permute(2, 0, 1)))
        # fractional points in [0, 1): no wrap translation, no extra phase
        return torch.cat(out, dim=-1)

    def eval_fn(A, positions):
        ng = frac_t.shape[0]
        return _blocked(block, frac_t, tabs.block_size(ng), A, positions,
                        ckpt=tabs.remat(ng))

    return eval_fn


def _int_lists(a0, eta):
    """Ewald translation and G integer lists of the reference lattice."""
    vol0 = abs(np.linalg.det(a0))
    rcut = np.sqrt(-np.log(1e-14) / eta)
    heights = np.array([
        vol0 / np.linalg.norm(np.cross(a0[(i + 1) % 3], a0[(i + 2) % 3]))
        for i in range(3)])
    nmax = np.ceil(rcut / heights).astype(int) + 1
    rng = [np.arange(-n, n + 1) for n in nmax]
    ints_t = np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
    gcut = 2.0 * np.sqrt(eta * -np.log(1e-14))
    bh = 2 * np.pi / np.linalg.norm(a0, axis=1)
    nmax = np.ceil(gcut / bh).astype(int) + 1
    rng = [np.arange(-n, n + 1) for n in nmax]
    ints_g = np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
    ints_g = ints_g[np.einsum("gi,gi->g", ints_g, ints_g) > 0]
    return ints_t, ints_g


def ewald_strain_fn(cell, dtype=None, eta=None, *, device="cuda"):
    """Differentiable ion-ion Ewald energy ``energy(A, dfrac=None)`` of the
    lattice matrix A and fractional atom displacements dfrac (natm, 3),
    tensors on ``device``.  eta and the translation/G integer lists are
    frozen at the reference lattice (the total is eta-independent)."""
    device = resolve_device(device)
    rdt = real_complex(dtype)[0]
    charges = np.asarray(cell.atom_charges(), dtype=np.float64)
    a0 = np.asarray(cell.a, dtype=np.float64)
    vol0 = float(abs(np.linalg.det(a0)))
    if eta is None:
        eta = float(np.pi / vol0 ** (2.0 / 3.0))
    frac_atoms = np.asarray(cell.atom_coords()) @ np.linalg.inv(a0)
    ints_t, ints_g = _int_lists(a0, eta)
    t0_idx = int(np.argmin(np.einsum("ti,ti->t", ints_t, ints_t)))
    e_self = float(np.sqrt(eta / np.pi) * np.sum(charges ** 2))
    zsum2 = float(np.sum(charges)) ** 2
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=device)
    z = t(charges)
    zz = z[:, None] * z[None, :]
    ints_t_t, ints_g_t, frac_t = t(ints_t), t(ints_g), t(frac_atoms)
    natm = len(charges)
    bad = torch.zeros((len(ints_t), natm, natm), dtype=torch.bool,
                      device=device)
    bad[t0_idx] = torch.eye(natm, dtype=torch.bool, device=device)
    gp0 = t(2.0 * np.pi * ints_g @ frac_atoms.T)            # (nG, natm)
    seta = math.sqrt(eta)

    def energy(A, dfrac=None):
        if dfrac is None:
            dfrac = torch.zeros((natm, 3), dtype=rdt, device=device)
        gp = gp0 + 2.0 * math.pi * ints_g_t @ dfrac.T
        sfr = torch.cos(gp) @ z
        sfi = torch.sin(gp) @ z
        sf2 = sfr * sfr + sfi * sfi
        vol = torch.abs(torch.linalg.det(A))
        B = 2.0 * math.pi * torch.linalg.inv(A).T
        positions = (frac_t + dfrac) @ A
        ts = ints_t_t @ A
        d = positions[:, None, :] - positions[None, :, :]
        dall = d[None] + ts[:, None, None, :]
        r2 = (dall * dall).sum(dim=-1)
        rsafe = torch.sqrt(torch.where(bad, torch.ones_like(r2), r2))
        e_real = 0.5 * torch.where(
            bad, torch.zeros_like(r2),
            zz * torch.special.erfc(seta * rsafe) / rsafe).sum()
        gs = ints_g_t @ B
        g2 = (gs * gs).sum(dim=1)
        e_recip = (2.0 * math.pi / vol) * torch.sum(
            torch.exp(-g2 / (4.0 * eta)) / g2 * sf2)
        e_bg = math.pi / (2.0 * eta * vol) * zsum2
        return e_real + e_recip - e_self - e_bg

    return energy


def madelung_strain_fn(cell, kmesh, dtype=None, *, device="cuda"):
    """Strain-differentiable Madelung constant ``mad(A)``, A the traced
    unit-cell lattice matrix: ``scf.integrals.madelung`` (a unit probe
    charge and its background on the kmesh-scaled lattice) on the
    differentiable Ewald sum."""
    device = resolve_device(device)
    rdt = real_complex(dtype)[0]
    km = np.asarray(kmesh, dtype=np.float64)
    a_sc0 = km[:, None] * np.asarray(cell.a)

    class _Probe:
        a = a_sc0

        @staticmethod
        def atom_charges():
            return np.array([1.0])

        @staticmethod
        def atom_coords():
            return np.zeros((1, 3))

    e_probe = ewald_strain_fn(_Probe, dtype=rdt, device=device)
    km_t = torch.as_tensor(km, dtype=rdt, device=device)

    def mad(A):
        return -2.0 * e_probe(km_t[:, None] * A)

    return mad


def _gth_vG(G2, zc, rloc, cloc, vg0, g2_zero):
    """GTH local form factor of |G|^2 (a tensor), as scf.integrals."""
    G2safe = torch.where(g2_zero, torch.ones_like(G2), G2)
    if rloc is None:
        return torch.where(g2_zero, torch.zeros_like(G2),
                           -4.0 * math.pi * zc / G2safe)
    x2 = G2safe * rloc ** 2
    poly = (cloc[0] + cloc[1] * (3.0 - x2)
            + cloc[2] * (15.0 - 10.0 * x2 + x2 ** 2)
            + cloc[3] * (105.0 - 105.0 * x2 + 21.0 * x2 ** 2 - x2 ** 3))
    v = torch.exp(-0.5 * x2) * (-4.0 * math.pi * zc / G2safe
                                + math.sqrt(8.0 * math.pi ** 3)
                                * rloc ** 3 * poly)
    return torch.where(g2_zero, torch.full_like(G2, vg0), v)


def _kernel_of(absg2, omega=None):
    """Bare (or erfc-screened, omega > 0 here) Coulomb kernel of the
    traced |q+G|^2; the q+G = 0 sample is 0 (bare) or pi/omega^2."""
    zero = absg2 < 1e-12
    cg = torch.where(zero, torch.zeros_like(absg2),
                     4.0 * math.pi / torch.where(zero, torch.ones_like(absg2),
                                                 absg2))
    if omega is not None:
        cg = torch.where(zero, torch.full_like(absg2, math.pi / omega ** 2),
                         cg * -torch.expm1(-absg2 / (4.0 * omega ** 2)))
    return cg


def make_cell_energy_fn(cell, kpts, dtype=None, two_electron="pw", df=None,
                        exxdiv=None, xc=None, hubbard=None, *,
                        device="cuda"):
    """Differentiable Lagrangian ``L(eps, dfrac, dm, wdm, w_trace)``: the
    lattice strained as A = a0 @ (1 + eps) and the atoms displaced by
    dfrac (natm, 3) in fractional coordinates.  One reverse sweep yields
    the stress (d/deps) and the forces (d/ddfrac = A g_cart for row
    vectors), the engine of ``scf.optimize.relax_cell``.

    ``two_electron``: 'pw' (exact plane wave) or 'isdf' (the frozen-point
    approximant of ``df`` re-fitted under the deformation).  ``exxdiv``,
    ``xc`` and ``hubbard`` as in ``scf.grad.make_energy_fn``; under strain
    both the Madelung constant and S trace, and the grid Exc takes the
    strained weight and G vectors."""
    if exxdiv not in (None, "ewald"):
        raise NotImplementedError(f"exxdiv={exxdiv!r} stress")
    device = resolve_device(device)
    rdt, cdt = real_complex(dtype)
    spec, hyb, hyb_sr, omg_hse = xc_setup(xc)
    hub_sites = None
    if hubbard:
        from fftisdf_tpu_torch.scf import hubbard as hub_mod
        hub_sites = hub_mod.build_sites(cell, hubbard)
    kpts = np.asarray(kpts)
    nk = len(kpts)
    mesh = tuple(int(m) for m in cell.mesh)
    ngrid = int(np.prod(mesh))
    a0 = np.asarray(cell.a)
    a0inv = np.linalg.inv(a0)
    t = lambda a, dt=rdt: torch.as_tensor(np.asarray(a), dtype=dt,
                                          device=device)
    a0_t = t(a0)
    kscaled = cell.get_scaled_kpts(kpts)
    frac_atoms = np.asarray(cell.atom_coords()) @ a0inv
    frac_atoms_t = t(frac_atoms)
    frac_grid = cell.gen_uniform_grids() @ a0inv
    gv0 = cell.get_Gv(mesh)
    gidx = np.rint(gv0 @ a0.T / (2.0 * np.pi))
    assert np.abs(gidx - gv0 @ a0.T / (2.0 * np.pi)).max() < 1e-6
    gidx_t, kscaled_t = t(gidx), t(kscaled)
    # strain-invariant phase-angle tables (integer x fractional products)
    tk = t(2.0 * np.pi * frac_grid @ kscaled.T)              # (ng, nk)
    ga = t(2.0 * np.pi * gidx @ frac_atoms.T)                # (ng, natm)
    kin_ph = torch.polar(torch.ones_like(tk), -tk).T          # (nk, ng)
    eiq = torch.polar(torch.ones_like(tk), tk).T              # (nk, ng)
    fn_ao = _strain_evaluator(cell, kpts, rdt, device=device)
    vloc_params = []
    for sym, _ in cell.atom:
        ps = cell._pseudo.get(sym)
        if ps is None:
            from fftisdf_tpu_torch.basis import data as basis_data
            zc = basis_data.ATOMIC_NUMBER[basis_data.element_symbol(sym)]
            vloc_params.append((float(zc), None, None, 0.0))
        else:
            c = np.zeros(4)
            c[: len(ps.cloc)] = ps.cloc
            vloc_params.append((float(ps.zion), float(ps.rloc), c,
                                float(integrals.gth_vloc_G0(ps))))
    proj_shells, hmat = integrals._projector_shells(cell)
    fn_proj = (_strain_evaluator(cell, kpts, rdt, shells=proj_shells,
                                 device=device) if proj_shells else None)
    hmat_t = t(hmat, cdt) if proj_shells else None
    e_nn = ewald_strain_fn(cell, dtype=rdt, device=device)
    mad_fn = (madelung_strain_fn(cell, kpt_mod.kpts_to_kmesh(cell, kpts),
                                 dtype=rdt, device=device)
              if exxdiv == "ewald" else None)
    g2_zero = t(np.einsum("gi,gi->g", gidx, gidx) < 1e-12, torch.bool)
    eye3 = torch.eye(3, dtype=rdt, device=device)

    if two_electron == "isdf":
        assert df is not None and df.mask is not None
        m0 = cell.mesh if df.m0 is None else df.m0
        frac_sel = (cell.gen_uniform_grids(m0) @ a0inv)[np.asarray(df.mask)]
        frac_sel = frac_sel - np.floor(frac_sel)
        fn_sel = _strain_evaluator(cell, kpts, rdt, frac_pts=frac_sel,
                                   device=device)
        ph = kpt_mod.get_phase(cell, kpts, kpt_mod.kpts_to_kmesh(cell, kpts))
        phase = torch.complex(t(ph.real), t(ph.imag))
        solver, rcond = df.solver, df.rcond

        def per_q(x4_q, y_q, fq, eq, B, vol):
            z_q, _ = solve_fitting(x4_q, y_q.T, method=solver, rcond=rcond)
            gk = (gidx_t + fq[None, :]) @ B
            absg2 = (gk * gk).sum(dim=1)
            spec_f = fft3(z_q * eq.conj()[None, :], mesh)
            kers = [_kernel_of(absg2)]
            if hyb_sr:
                kers.append(_kernel_of(absg2, omg_hse))
            return torch.stack([
                (ifft3(spec_f * c, mesh) * eq[None, :] * (vol / ngrid))
                @ z_q.mH for c in kers])

        def e2_isdf(A, B, vol, positions, f_k, dm):
            x_k = fn_sel(A, positions)
            x4_k = _stripe_quartic(x_k, phase)
            nip = x_k.shape[1]
            sector_bytes = ngrid * nip * cdt.itemsize
            y = _remat(_rhs_full, f_k, x_k, phase, phase,
                       nbytes=nk * sector_bytes)
            wq = torch.stack([_remat(per_q, x4_k[q], y[q], kscaled_t[q],
                                     eiq[q], B, vol, nbytes=sector_bytes,
                                     policy=True)
                              for q in range(nk)])
            wq, wq_sr = wq[:, 0], (wq[:, 1] if hyb_sr else None)
            dm_s = dm if dm.ndim == 4 else dm[None]
            fac = 0.5 if dm.ndim == 4 else 0.25
            dm_t = dm_s.sum(dim=0) if dm.ndim == 4 else dm
            vj = jkm.get_j_kpts(x_k, wq[0], dm_t[None])[0]
            e = 0.5 * _tr(dm_t, vj) / nk
            if hyb != 0.0:
                vk = jkm.get_k_kpts(x_k, wq, phase, dm_s)
                e = e - fac * hyb * _tr(dm_s, vk) / nk
            if hyb_sr != 0.0:
                vk = jkm.get_k_kpts(x_k, wq_sr, phase, dm_s)
                e = e - fac * hyb_sr * _tr(dm_s, vk) / nk
            return e
    elif two_electron != "pw":
        raise ValueError(two_electron)

    def pair_energy(f1, f2, d1, d2, tq, fq, B, omega):
        """Exchange energy of one k pair: Poisson solve of every AO pair
        density conj(f1_m) f2_l, contracted with the densities."""
        nao = f1.shape[-1]
        gk = (gidx_t + fq[None, :]) @ B
        cg = _kernel_of((gk * gk).sum(dim=1), omega)
        eiqr = torch.polar(torch.ones_like(tq), tq)
        rho = (f1.conj()[:, :, None] * f2[:, None, :]).reshape(ngrid, -1)
        work = fft3((rho * eiqr.conj()[:, None]).T, mesh) * cg
        v = (ifft3(work, mesh) * eiqr[None, :]).T.reshape(ngrid, nao, nao)
        u = f2.conj() @ d2.T                                 # (g, l)
        return torch.einsum("gml,gl,gn,nm->", v, u, f1, d1).real

    def ex_pairs(f_k, dmat, B, w, omega=None):
        pair = lambda *a: pair_energy(*a, omega)
        nbytes = ngrid * f_k.shape[-1] ** 2 * cdt.itemsize
        e = 0.0
        for k1 in range(nk):
            for k2 in range(nk):
                e = e + _remat(pair, f_k[k1], f_k[k2], dmat[k1], dmat[k2],
                               tk[:, k2] - tk[:, k1],
                               kscaled_t[k2] - kscaled_t[k1], B,
                               nbytes=nbytes)
        return e * (w / nk ** 2)

    def energy(eps, dfrac, dm, wdm, w_trace):
        A = a0_t @ (eye3 + eps)
        B = 2.0 * math.pi * torch.linalg.inv(A).T
        vol = torch.abs(torch.linalg.det(A))
        w = vol / ngrid
        positions = (frac_atoms_t + dfrac) @ A
        ga_t = ga + 2.0 * math.pi * gidx_t @ dfrac.T          # G.r angles
        f_k = fn_ao(A, positions)                             # (nk, ng, nao)
        dm_tot = dm[0] + dm[1] if dm.ndim == 4 else dm
        wdm_tot = wdm[0] + wdm[1] if wdm.ndim == 4 else wdm

        # kinetic: (1/nk) sum_k tr(D_k T_k)
        c = fft3((f_k * kin_ph[:, :, None]).transpose(1, 2), mesh) / ngrid
        gk = (gidx_t[None] + kscaled_t[:, None, :]) @ B       # (nk, ng, 3)
        g2k = 0.5 * (gk * gk).sum(dim=-1)
        tmat = vol * ((c.conj() * g2k[:, None, :]) @ c.transpose(1, 2))
        e_kin = _tr(dm_tot, tmat) / nk

        # local PSP against the mesh density
        gv = gidx_t @ B
        G2 = (gv * gv).sum(dim=1)
        fr = torch.zeros(ngrid, dtype=rdt, device=device)
        fi = torch.zeros(ngrid, dtype=rdt, device=device)
        for ia, (zc, rloc, cloc, vg0) in enumerate(vloc_params):
            vG = _gth_vG(G2, zc, rloc, cloc, vg0, g2_zero)
            fr = fr + vG * torch.cos(ga_t[:, ia])
            fi = fi - vG * torch.sin(ga_t[:, ia])
        vgrid = ifft3(torch.complex(fr, fi), mesh).real * (ngrid / vol)
        n_r = ((f_k @ dm_tot) * f_k.conj()).sum(dim=(0, 2)).real / nk
        e_loc = w * torch.sum(n_r * vgrid)

        e_nl = 0.0
        if fn_proj is not None:
            p_k = fn_proj(A, positions)
            bmat = w * (p_k.mH @ f_k)
            e_nl = _tr(dm_tot, bmat.mH @ hmat_t @ bmat) / nk

        s_k = w * (f_k.mH @ f_k)
        e_pulay = -_tr(wdm_tot, s_k) / nk

        e_mad = 0.0
        if mad_fn is not None and hyb != 0.0:
            fac = -0.5 if dm.ndim == 4 else -0.25
            e_mad = fac * hyb * mad_fn(A) / nk * _tr(dm, s_k @ dm @ s_k)

        e_xtra = 0.0
        if spec is not None or hub_sites is not None:
            dm_spin = dm if dm.ndim == 4 else torch.stack([dm, dm]) * 0.5
        if spec is not None:
            # tau: the k.r phases ride the invariant angle table; strain
            # enters through the AO values, the strained G vectors and the
            # strained k of (grad + ik) u
            e_xtra = e_xtra + exc_traced(spec, f_k, dm_spin, nk, gv, mesh, w,
                                         kpts=kscaled_t @ B, angle=tk)
        if hub_sites is not None:
            from fftisdf_tpu_torch.scf import hubbard as hub_mod
            e_xtra = e_xtra + hub_mod.eu_and_vu_traced(
                dm_spin, hub_mod.sqrtm_traced(s_k), hub_sites)[0]

        base = e_kin + e_loc + e_nl + e_pulay + e_mad + e_xtra + w_trace \
            + e_nn(A, dfrac)
        if two_electron == "isdf":
            return base + e2_isdf(A, B, vol, positions, f_k, dm)

        # Hartree: (vol / 2 ngrid^2) sum_G coulG |FFT(n)|^2, G = 0 dropped
        nG = fft3(n_r.to(cdt), mesh)
        e_j = (vol / (2.0 * ngrid ** 2)) * torch.sum(
            _kernel_of(G2) * (nG.real ** 2 + nG.imag ** 2))

        def ex_all(dmat, fac):
            e = 0.0
            if hyb != 0.0:
                e = e - fac * hyb * ex_pairs(f_k, dmat, B, w)
            if hyb_sr != 0.0:
                e = e - fac * hyb_sr * ex_pairs(f_k, dmat, B, w,
                                                omega=omg_hse)
            return e

        if hyb == 0.0 and hyb_sr == 0.0:
            e_k = 0.0          # pure functional: no pairwise Poisson loop
        elif dm.ndim == 4:
            e_k = ex_all(dm[0], 0.5) + ex_all(dm[1], 0.5)
        else:
            e_k = ex_all(dm, 0.25)
        return base + e_j + e_k

    return energy


def make_cell_grad_fn(cell, kpts, dtype=None, two_electron="pw", df=None,
                      exxdiv=None, xc=None, hubbard=None, *, device=None):
    """Reusable evaluator ``fn(mf, eps=None, dfrac=None) -> (val,
    dL/deps (3, 3), dL/ddfrac (natm, 3))``, host arrays out.  One closure,
    built at the reference lattice, serves a whole variable-cell
    trajectory (keep strains and displacements sub-cell).  Runs on
    ``device`` (None: ``df.device``, else ``cuda``)."""
    device = _device_of(df, device)
    rdt, cdt = real_complex(dtype)
    e_fn = make_cell_energy_fn(cell, kpts, dtype=rdt,
                               two_electron=two_electron, df=df,
                               exxdiv=exxdiv, xc=xc, hubbard=hubbard,
                               device=device)

    def fn(mf, eps=None, dfrac=None):
        assert getattr(mf, "dm", None) is not None, "run mf.kernel() first"
        check_functional(mf, xc, hubbard, exxdiv, what="cell-gradient")
        natm = cell.natm
        eps = np.zeros((3, 3)) if eps is None else np.asarray(eps)
        dfrac = np.zeros((natm, 3)) if dfrac is None else np.asarray(dfrac)
        dm, wdm, w_trace = scf_tensors(mf, device, cdt)
        e_t = torch.as_tensor(eps, dtype=rdt,
                              device=device).requires_grad_(True)
        f_t = torch.as_tensor(dfrac, dtype=rdt,
                              device=device).requires_grad_(True)
        with torch.enable_grad():
            val = e_fn(e_t, f_t, dm, wdm, w_trace)
            geps, gfrac = torch.autograd.grad(val, (e_t, f_t))
        return (float(val.detach()), geps.cpu().numpy(),
                gfrac.cpu().numpy())

    return fn


def kernel(mf, dtype=None, two_electron="pw", df=None):
    """Stress tensor sigma (3, 3) (Ha/bohr^3), pressure (Ha/bohr^3) and
    the Lagrangian value (== e_tot at eps = 0) of a converged SCF; sigma > 0
    components mean the cell wants to shrink.  ``two_electron='isdf'``
    differentiates the frozen-point ISDF approximant of ``df`` (on its
    device), 'pw' the exact plane-wave energy (on ``mf.device``)."""
    if getattr(mf, "trunc", None) is not None:
        raise NotImplementedError(
            "stress with a truncated Coulomb kernel (the traced energy is "
            "the bare-kernel functional)")
    device = df.device if df is not None else mf.device
    val, g, _ = make_cell_grad_fn(mf.cell, mf.kpts, dtype=dtype,
                                  two_electron=two_electron, df=df,
                                  exxdiv=getattr(mf, "exxdiv", None),
                                  xc=getattr(mf, "xc", None),
                                  hubbard=getattr(mf, "hubbard", None),
                                  device=device)(mf)
    sigma = 0.5 * (g + g.T) / float(mf.cell.vol)
    pressure = -np.trace(sigma) / 3.0
    return sigma, float(pressure), val
