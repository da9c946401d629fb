"""G0W0 quasiparticle energies on the ISDF factorisation.

Counterpart of ``fftisdf_tpu/scf/gw.py``.  The screened interaction lives
in the nip x nip interpolation space,

    Wc_q(iw) = w_q chi_q(iw) (1 - w_q chi_q(iw))^{-1} w_q,
    chi_q(iw) = (1/nk) sum_p g_p(iw) A[:, p] A[:, p]^H,

with the pair amplitudes ``A_{I,(k,ia)} = conj(xo_k)_Ii xv_{k+q}_Ia`` and
ring factor ``g_p = -4 Delta_p / (Delta_p^2 + w^2)`` of ``scf.rpa`` (chi
is A g A^H where the JAX package has A g A^T: ``scf.rpa`` says why).  The
correlation self-energy is sampled on the imaginary axis,

    Sigma^c_{n,k}(iw) = -(1/(2 pi nk)) sum_q int_0^inf dw' sum_m
        [B^T Wc_q(iw') conj(B)]_{nm} * 2(iw - e_m) / ((iw - e_m)^2 + w'^2),
    B_{I,m} = conj(x_k c_n)_I (x_{k+q} c_m)_I,   e_m relative to eps_F,

then continued to the real axis with a Thiele/Pade continued fraction
and the QP equation solved by Newton:

    e_QP = e_mf + Re Sigma^c(e_QP - eps_F) + <n| Sigma_x - v_xc^eff |n>.

For a KRHF reference the static correction vanishes identically; for
KRKS (hybrids and +U included) it is -(1-hyb)/2 <vk> - <vxc> - <vU>.

Wc_q(iw') does not depend on k, so it is formed once per sector, all nw
frequencies as one batched solve (the JAX package rebuilds it for every
k inside the sector loop), and then contracted with the pair vectors of
every k; the frequency convolution runs on the device too, and Sigma is
fetched once.  The Pade continuation, the QP solve and the dense oracles
are numpy, as in the JAX package.  Tensors stay on the device of the ISDF
state.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.scf.mp2 import _mo_blocks, _pair_mat  # noqa: F401
from fftisdf_tpu_torch.scf.rpa import (_chi, _freq_blocks, _freq_grid,
                                       _sector_pairs)
from fftisdf_tpu_torch.utils.device import (as_tensor, memory_blocks,
                                            to_numpy)


# ----------------------------------------------------------------------
# Pade / Thiele analytic continuation (host; the arrays are tiny)

def pade_thiele(z, f):
    """Continued-fraction coefficients interpolating f(z) at the nodes z.

    Thiele reciprocal-difference recursion; returns (a, z) with a[0] =
    f(z[0]) and the model
        C(x) = a0 / (1 + a1 (x-z0) / (1 + a2 (x-z1) / (1 + ...))).
    """
    z = np.asarray(z, dtype=complex)
    f = np.asarray(f, dtype=complex)
    n = len(z)
    g = np.zeros((n, n), dtype=complex)
    g[0] = f
    for i in range(1, n):
        g[i, i:] = (g[i - 1, i - 1] - g[i - 1, i:]) / (
            (z[i:] - z[i - 1]) * g[i - 1, i:])
    return np.diag(g).copy(), z


def pade_eval(coeffs, x):
    """Evaluate the Thiele continued fraction at (an array of) points x."""
    a, z = coeffs
    x = np.asarray(x, dtype=complex)
    n = len(a)
    # backward recurrence: t_n = 1, t_k = 1 + a_{k+1} (x - z_k) / t_{k+1}
    t = np.ones_like(x)
    for k in range(n - 2, -1, -1):
        t = 1.0 + a[k + 1] * (x - z[k]) / t
    return a[0] / t


# ----------------------------------------------------------------------
# nip-space Sigma^c(iw) sampling

def _screened_wc(pair_amp, delta, wq, omega, inv_nk):
    """Wc_q(iw') of one sector at every quadrature node: (nw, nip, nip)
    m (1 - m)^{-1} w_q, m = w_q chi_q(iw'), in frequency blocks sized
    from the device's free memory."""
    nip = wq.shape[0]
    eye = torch.eye(nip, dtype=wq.dtype, device=wq.device)
    out = torch.empty((len(omega), nip, nip), dtype=wq.dtype,
                      device=wq.device)
    for blk in _freq_blocks(len(omega), pair_amp, ntemp=6):
        m = wq @ (inv_nk * _chi(pair_amp, delta, omega[blk]))
        out[blk] = m @ torch.linalg.solve(eye - m, wq)
    return out


def _sigma_q_contrib(wc, bk):
    """Screened matrix elements of one sector on the w' quadrature grid:
    (nw, nb) [B^T Wc_q(iw') conj(B)] per frequency, for the pair vectors
    B (nip, nb) = conj(x_k c_n) * (x_{k+q} c_m) of a block of k."""
    return torch.sum(bk * (wc @ bk.conj()), dim=1)


def sigma_c_iw(df, mf, orbs=None, nw=40):
    """Sample Sigma^c_{n,k} on the imaginary axis.

    Returns (sigma (nk, nsel, nw) complex, iw_nodes (nw,), efermi, orbs).
    The iw sampling nodes coincide with the w' quadrature nodes (both the
    Gauss-Legendre map of scf.rpa), so oracle comparisons share grids.
    """
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    assert mo_c.ndim == 3, "restricted (KRHF/KRKS) reference required"
    nocc = int(round(mo_o[0].sum() / 2))
    nmo = mo_c.shape[-1]
    assert np.allclose(mo_o, mo_o.round()), \
        "fractional occupations (smearing) unsupported in G0W0"
    if orbs is None:
        orbs = list(range(nmo))
    orbs = list(orbs)
    nsel = len(orbs)

    efermi = 0.5 * (mo_e[:, nocc - 1].max() + mo_e[:, nocc:].min())
    k2c = df.kconserv2()
    xm, xo, xv = _mo_blocks(df, mo_c, nocc)
    xn = xm[..., orbs]                                  # (nk, nip, nsel)
    dev, rdt = df.x_k.device, df.rdtype
    omega, weight = _freq_grid(nw)
    om_d = torch.as_tensor(omega, dtype=rdt, device=dev)
    wt_d = torch.as_tensor(weight, dtype=rdt, device=dev)
    em_all = torch.as_tensor(mo_e - efermi, dtype=rdt, device=dev)
    # frequency-convolution kernel K[j, l, m] = wt_j 2 (iw_l - e_m) /
    # ((iw_l - e_m)^2 + w'_j^2), e_m at the partner k-point
    a_all = 1j * om_d[None, :, None] - em_all[:, None, :]    # (nk, nl, nmo)
    kern_all = (wt_d[None, :, None, None] * 2.0 * a_all[:, None]
                / (a_all[:, None] ** 2
                   + om_d[None, :, None, None] ** 2))        # (nk, j, l, m)
    sigma = torch.zeros((nk, nsel, nw), dtype=df.cdtype, device=dev)
    nip = xm.shape[1]
    for q in range(nk):
        pair_amp, delta = _sector_pairs(df, xo, xv, mo_e, nocc, q)
        wc = _screened_wc(pair_amp, delta, df.wq[q], om_d, 1.0 / nk)
        del pair_amp
        partner = torch.as_tensor(
            [int(np.nonzero(k2c[k] == q)[0][0]) for k in range(nk)],
            device=dev)
        # a k block's (nw, nip, kc nb) product and its elementwise one
        for ks in memory_blocks(nk, 2 * nw * nip * nsel * nmo
                                * xm.element_size(), dev):
            kp = partner[ks]
            bmat = _pair_mat(xn[ks], xm[kp])            # (kc, nip, nb)
            kc = bmat.shape[0]
            bk = bmat.permute(1, 0, 2).reshape(nip, kc * nsel * nmo)
            contrib = _sigma_q_contrib(wc, bk).reshape(nw, kc, nsel, nmo)
            sigma[ks] += torch.einsum("jknm,kjlm->knl", contrib,
                                      kern_all[kp].to(contrib.dtype))
        del wc
    sigma = to_numpy(sigma) * (-1.0 / (2.0 * np.pi * nk))
    return sigma, omega, efermi, orbs


# ----------------------------------------------------------------------
# static corrections (exchange minus reference xc) and the QP equation

def _static_correction(df, mf, orbs):
    """<n| Sigma_x - v_xc^eff |n> per (k, n); exactly zero for KRHF."""
    mo_c = np.asarray(mf.mo_coeff)
    spec = getattr(mf, "_spec", None)
    if spec is None:
        return np.zeros((len(mo_c), len(orbs)))
    from fftisdf_tpu_torch.scf.hf import _build_dm

    hyb = spec.hyb
    dm = np.asarray(_build_dm(mo_c, np.asarray(mf.mo_occ)))
    dm_dev = as_tensor(dm.astype(np.complex128), df.x_k.device, df.cdtype)
    host = lambda t: to_numpy(t).astype(np.complex128, copy=False)
    _, vk = df.get_jk(dm_dev, with_j=False, exxdiv=mf.exxdiv)
    vk = host(vk)
    _, vxc, _ = mf._xc_eval(mf._dm_device(dm[None]), nspin=1)
    corr_mat = -0.5 * (1.0 - hyb) * vk - vxc[0]
    if getattr(spec, "hyb_sr", 0.0):
        # screened-hybrid reference (HSE06): its Fock carried
        # -0.5*hyb_sr*K_SR, which is part of v_xc^eff, not of Sigma_x
        _, vk_sr = df.get_jk(dm_dev, with_j=False, omega=-spec.omega)
        corr_mat = corr_mat + 0.5 * spec.hyb_sr * host(vk_sr)
    if getattr(mf, "_hub_sites", None) is not None:
        _, vu = mf._hubbard_eu_vu(np.stack([dm, dm]) * 0.5)
        corr_mat = corr_mat - vu[0]
    nk = len(mo_c)
    out = np.empty((nk, len(orbs)))
    for k in range(nk):
        c = mo_c[k][:, orbs]
        out[k] = np.einsum("mp,mn,np->p", c.conj(), corr_mat[k], c).real
    return out


def _solve_qp(e_mf, corr, model, efermi, tol=1e-8, maxiter=100):
    """Newton solve of e = e_mf + corr + Re Sigma~(e - eF); returns (e, Z)."""
    e = e_mf
    h = 1e-4
    z_fac = 1.0
    for _ in range(maxiter):
        s0 = pade_eval(model, np.array([e - efermi])).real[0]
        sp = pade_eval(model, np.array([e - efermi + h])).real[0]
        sm = pade_eval(model, np.array([e - efermi - h])).real[0]
        ds = (sp - sm) / (2.0 * h)
        f = e - e_mf - corr - s0
        df_ = 1.0 - ds
        z_fac = 1.0 / max(df_, 1e-2)
        step = f / df_ if abs(df_) > 1e-2 else f
        e_new = e - np.clip(step, -0.5, 0.5)
        if abs(e_new - e) < tol:
            return e_new, min(max(z_fac, 0.0), 1.5)
        e = e_new
    return e, min(max(z_fac, 0.0), 1.5)


def g0w0(df, mf, orbs=None, nw=40, npade=18):
    """G0W0 quasiparticle energies from a converged KRHF/KRKS reference.

    Returns (e_qp (nk, nsel), info) with info carrying 'z' factors,
    'sigma_iw' samples, 'efermi', 'orbs', and the static 'correction'.
    """
    sigma, iw, efermi, orbs = sigma_c_iw(df, mf, orbs=orbs, nw=nw)
    corr = _static_correction(df, mf, orbs)
    mo_e = np.asarray(mf.mo_energy)
    nk, nsel, _ = sigma.shape

    # Pade nodes: spread over the low-frequency 3/4 of the grid where the
    # QP energies live; an even count for a balanced continued fraction
    npade = min(npade, nw) & ~1
    idx = np.unique(np.linspace(0, int(nw * 0.75), npade).astype(int))
    zs = 1j * iw[idx]

    e_qp = np.empty((nk, nsel))
    zfac = np.empty((nk, nsel))
    for k in range(nk):
        for n in range(nsel):
            model = pade_thiele(zs, sigma[k, n, idx])
            e_qp[k, n], zfac[k, n] = _solve_qp(
                mo_e[k][orbs[n]], corr[k, n], model, efermi)
    info = {"z": zfac, "sigma_iw": sigma, "iw": iw, "efermi": efermi,
            "orbs": orbs, "correction": corr, "nw": nw}
    return e_qp, info


# ----------------------------------------------------------------------
# dense oracles (tests): ov-pair-space quadrature and exact pole sum

def sigma_c_ov_space(eri_mo, mo_energy, nocc, nw=40):
    """Gamma-point oracle: Sigma^c(iw) from explicit MO ERIs in the full
    ov pair space, on the quadrature/sampling grid of :func:`sigma_c_iw`.

    Returns (sigma (nmo, nw) complex, iw, efermi)."""
    eri = np.asarray(eri_mo)
    nmo = eri.shape[0]
    eps = np.asarray(mo_energy)
    efermi = 0.5 * (eps[nocc - 1] + eps[nocc])
    em = eps - efermi
    no, nv = nocc, nmo - nocc
    nov = no * nv
    v_ov = eri[:no, no:, :no, no:].reshape(nov, nov)
    delta = (eps[no:][None, :] - eps[:no][:, None]).ravel()
    c_pm = eri[:, :, :no, no:].reshape(nmo * nmo, nov)

    omega, weight = _freq_grid(nw)
    sigma = np.zeros((nmo, nw), dtype=complex)
    eye = np.eye(nov)
    for om, wt in zip(omega, weight):
        g = -4.0 * delta / (delta * delta + om * om)
        # g (1 - v g)^{-1} is symmetric (= (g^{-1} - v)^{-1}); with real
        # orbitals C[(n,m)] = C[(m,n)], so (nm|Wc|mn) is the DIAGONAL of
        # M = (C g) (1 - v g)^{-1} C^T over the (n,m) pair index.
        u = np.linalg.solve(eye - v_ov * g[None, :], c_pm.T)   # (nov, pm)
        w_nm = np.einsum("pj,jp->p", c_pm * g[None, :], u)
        w_nm = w_nm.reshape(nmo, nmo)
        a = 1j * omega[:, None] - em[None, :]      # (nl, nmo)
        kern = wt * 2.0 * a / (a ** 2 + om ** 2)   # (nl, nmo)
        sigma += w_nm @ kern.T                     # (nmo, nl)
    return -sigma / (2.0 * np.pi), omega, efermi


def drpa_poles(eri_mo, mo_energy, nocc):
    """Exact dRPA pole decomposition of Sigma^c at the gamma point.

    Diagonalises C = D^2 + 4 D^{1/2} v D^{1/2} (closed-shell direct RPA)
    and returns (Omega (ns,), resid (nmo, nmo, ns), efermi) such that

        Sigma^c_n(z) = sum_s [ sum_{m<no} resid[n,m,s] / (z - e_m + Om_s)
                             + sum_{m>=no} resid[n,m,s] / (z - e_m - Om_s) ]

    with e relative to efermi: the analytic real-axis oracle of the Pade
    continuation."""
    eri = np.asarray(eri_mo)
    nmo = eri.shape[0]
    eps = np.asarray(mo_energy)
    efermi = 0.5 * (eps[nocc - 1] + eps[nocc])
    no, nv = nocc, nmo - nocc
    nov = no * nv
    v_ov = eri[:no, no:, :no, no:].reshape(nov, nov)
    delta = (eps[no:][None, :] - eps[:no][:, None]).ravel()
    dhalf = np.sqrt(delta)
    cmat = np.diag(delta ** 2) + 4.0 * (dhalf[:, None] * v_ov
                                        * dhalf[None, :])
    om2, zvec = np.linalg.eigh(cmat)
    omega_s = np.sqrt(np.maximum(om2, 0.0))
    c_pm = eri[:, :, :no, no:].reshape(nmo * nmo, nov)
    r = c_pm @ (dhalf[:, None] * zvec)            # (nmo*nmo, ns)
    r = r.reshape(nmo, nmo, nov)
    resid = 2.0 * r ** 2 / np.maximum(omega_s, 1e-300)[None, None, :]
    return omega_s, resid, efermi


def sigma_c_from_poles(omega_s, resid, efermi, mo_energy, nocc, z):
    """Evaluate the pole-sum oracle at (an array of) complex z (rel. eF)."""
    eps = np.asarray(mo_energy) - efermi
    z = np.asarray(z, dtype=complex)
    nmo = len(eps)
    out = np.zeros(z.shape + (nmo,), dtype=complex)
    for m in range(nmo):
        sgn = -1.0 if m < nocc else 1.0
        denom = z[..., None] - eps[m] - sgn * omega_s  # (..., ns)
        out += np.einsum("ns,...s->...n", resid[:, m, :], 1.0 / denom)
    return out
