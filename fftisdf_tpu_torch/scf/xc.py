"""Exchange-correlation functionals for periodic KS-DFT on the GPW grid.

Counterpart of ``fftisdf_tpu/scf/xc.py``.  Every functional is an energy
density per unit volume ``f(rho_s, sigma[, tau])`` on the uniform grid, and
the potential is ``torch.autograd.grad`` of the *discrete* total energy

    Exc(rho) = (vol/ng) * sum_g f(rho(g), grad_fft rho(g))

through the FFT density gradient (``linalg.fft``), divided by the
quadrature weight.  No GGA divergence term is written by hand and no
derivative is taken in closed form: the FFT adjoint gives exactly the
derivative of the discretised energy, so the energy/potential pair is
consistent to machine precision and the SCF is variational on the grid in
use.  Everything runs spin-resolved: ``rho`` is (2, ng), restricted
callers pass rho_total/2 in both channels.

Functionals (the JAX package's registry, parameters from the papers):
Slater exchange, PW92 and VWN5 correlation, PBE exchange and correlation,
the HJS short-range omega-PBE exchange of HSE06, B88 exchange, LYP
correlation (Miehlich's closed form) and SCAN exchange and correlation;
mixes LDA, PBE, PBE0, BLYP, B3LYP (VWN5), SCAN, SCAN0 and HSE06.

Clamps at their boundary: the JAX package clamps with
``maximum``/``minimum``/``clip``, whose derivative splits 1/2-1/2 at an
exact tie, and ties do occur (zeta = +-1 on a fully polarised density,
s^2 = 0 on a uniform one).  ``torch.clamp`` would pass the whole
gradient, so the clamps here are ``torch.maximum``/``torch.minimum``
against tensor constants, which split it as JAX does.

Grid passes over Bloch AOs (densities, kinetic-energy densities, AO
matrices of a grid potential) are in :func:`xc_pass` and its helpers,
streamed over blocks of k-points sized from the device's free memory, so
that no (nspin, nk, ng, nao) intermediate is ever formed; the counter
``scf.xc_kblocks`` (``utils.profiling``, recorded only while it is on)
adds up the blocks streamed.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.utils import profiling
from fftisdf_tpu_torch.utils.device import free_memory_bytes

# ----------------------------------------------------------------------
# parameters

_CX = 0.75 * (3.0 / np.pi) ** (1.0 / 3.0)      # Slater exchange constant
_PBE_KAPPA = 0.804
_PBE_MU = 0.2195149727645171                   # beta * pi^2 / 3
_PBE_BETA = 0.066725
_PBE_GAMMA = (1.0 - np.log(2.0)) / np.pi ** 2

# PW92 eq. (10) parameter triples: (A, alpha1, beta1, beta2, beta3, beta4)
_PW92_EC0 = (0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
_PW92_EC1 = (0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
_PW92_MAC = (0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
_PW92_F2 = 4.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))   # f''(0) = 1.709921...


def _max(x, c):
    """``maximum(x, c)`` with JAX's derivative: 1/2 to x at a tie."""
    return torch.maximum(x, x.new_tensor(c))


def _min(x, c):
    return torch.minimum(x, x.new_tensor(c))


def _floor(x):
    """Density floor: keeps rho^(-1/3)-type factors finite in vacuum
    regions without perturbing physical densities (the derivative of the
    clamp is zero below the floor)."""
    return _max(x, 1e-12 if x.dtype == torch.float64 else 1e-10)


# ----------------------------------------------------------------------
# functional terms: f(rho (2, g), sigma (3, g) | None, tau (2, g) | None)
# -> (g,) energy/vol.  Kind: 0 = LDA (rho only), 1 = GGA (+sigma),
# 2 = meta-GGA (+tau).

def _uniform_x(rho):
    """Spin-scaled Slater exchange energy density."""
    r = _floor(rho)
    return -_CX * 2.0 ** (1.0 / 3.0) * torch.sum(r ** (4.0 / 3.0), dim=0)


def _ss(sigma):
    """The same-spin rows |grad rho_a|^2, |grad rho_b|^2 of sigma."""
    return torch.stack([sigma[0], sigma[2]])


def _pbe_x(rho, sigma, tau=None):
    """PBE exchange via spin scaling: sum_s unif_x(2 rho_s) Fx(s_s) / 2."""
    r = _floor(2.0 * rho)                       # (2, g): the 2*rho_s channel
    sig = 4.0 * _ss(sigma)                      # |grad(2 rho_s)|^2
    kf = (3.0 * np.pi ** 2 * r) ** (1.0 / 3.0)
    s2 = sig / _floor((2.0 * kf * r) ** 2)
    fx = 1.0 + _PBE_KAPPA - _PBE_KAPPA / (1.0 + _PBE_MU * s2 / _PBE_KAPPA)
    return 0.5 * torch.sum(-_CX * r ** (4.0 / 3.0) * fx, dim=0)


def _pw92_G(rs, A, a1, b1, b2, b3, b4):
    """PW92 eq. (10) (p = 1); returns G(rs) (== -alpha_c for the MAC set)."""
    srs = torch.sqrt(rs)
    den = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2.0 * A * (1.0 + a1 * rs) * torch.log1p(1.0 / den)


def _fz(zeta):
    """(f(zeta), 1 - zeta floored, 1 + zeta floored) of PW92 eq. (9)."""
    omz = _floor(1.0 - zeta)                    # d/dzeta of (1 +- z)^(4/3)
    opz = _floor(1.0 + zeta)                    # diverges at |z| = 1
    fz = (opz ** (4.0 / 3.0) + omz ** (4.0 / 3.0) - 2.0) \
        / (2.0 ** (4.0 / 3.0) - 2.0)
    return fz, omz, opz


def _pw92_eps(rs, zeta):
    """PW92 correlation energy per particle eps_c(rs, zeta), eq. (8)."""
    ec0 = _pw92_G(rs, *_PW92_EC0)
    ec1 = _pw92_G(rs, *_PW92_EC1)
    mac = _pw92_G(rs, *_PW92_MAC)               # = -alpha_c(rs)
    fz, _, _ = _fz(zeta)
    z4 = zeta ** 4
    return ec0 - mac * (fz / _PW92_F2) * (1.0 - z4) + (ec1 - ec0) * fz * z4


def _rs_zeta(rho):
    rt = _floor(torch.sum(rho, dim=0))
    rs = (3.0 / (4.0 * np.pi * rt)) ** (1.0 / 3.0)
    # jnp.clip: minimum(maximum(x, -1), 1), each splitting a tie
    zeta = _min(_max((rho[0] - rho[1]) / rt, -1.0), 1.0)
    return rt, rs, zeta


def _pw92_c(rho):
    rt, rs, zeta = _rs_zeta(rho)
    return rt * _pw92_eps(rs, zeta)


def _pbe_c(rho, sigma, tau=None):
    rt, rs, zeta = _rs_zeta(rho)
    eps = _pw92_eps(rs, zeta)
    phi = 0.5 * (_floor(1.0 + zeta) ** (2.0 / 3.0)
                 + _floor(1.0 - zeta) ** (2.0 / 3.0))
    kf = (3.0 * np.pi ** 2 * rt) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / np.pi)
    sig_t = sigma[0] + 2.0 * sigma[1] + sigma[2]    # |grad rho_total|^2
    t2 = sig_t / _floor((2.0 * phi * ks * rt) ** 2)
    g3 = _PBE_GAMMA * phi ** 3
    bg = _PBE_BETA / _PBE_GAMMA
    # A = (beta/gamma) / (exp(-eps/g3) - 1); expm1 keeps eps -> 0- stable
    aa = bg / _floor(torch.expm1(-eps / g3))
    at2 = aa * t2
    h = g3 * torch.log1p(bg * t2 * (1.0 + at2) / (1.0 + at2 + at2 * at2))
    return rt * (eps + h)


def _lda_x_term(rho, sigma, tau=None):
    return _uniform_x(rho)


# ---- HJS short-range omega-PBE exchange (for screened hybrids) ---------

# Henderson-Janesko-Scuseria model of the PBE exchange hole attenuated by
# erfc(omega r) (JCP 128, 194105 (2008)): closed-form SR enhancement
# F_x^SR(s, nu) with nu = omega / kF.
_HJS_A = 0.757211
_HJS_B = -0.106364
_HJS_C = -0.118649
_HJS_D = 0.609650
_HJS_POLY_A = (0.0159941, 0.0852995, -0.160368, 0.152645, -0.0971263,
               0.0422061)                       # s^2 .. s^7 numerator
_HJS_POLY_B = (5.33319, -12.4780, 11.0988, -5.11013, 1.71468, -0.610380,
               0.307555, -0.0770547, 0.0334840)  # s^1 .. s^9 denominator


def _hjs_fx_sr(s2, nu):
    """HJS SR-PBE enhancement factor F_x^SR(s^2, nu) (elementwise)."""
    # cap s^2: past s ~ 1e3 the rational H(s) sits at its asymptote, and
    # the raw s^9 denominator would overflow float32 in vacuum regions
    s2 = _min(s2, 1e8)
    s = torch.sqrt(_floor(s2))  # clamped: d(sqrt)/ds2 finite at s2 = 0
    num = s2 * sum(c * s ** i for i, c in enumerate(_HJS_POLY_A))
    den = 1.0 + sum(c * s ** (i + 1) for i, c in enumerate(_HJS_POLY_B))
    zeta = _max(s2 * num / den, 0.0)            # zeta = s^2 H(s) >= 0
    eta = _HJS_A + zeta
    lam = _HJS_D + zeta
    ff = (1.0 - s2 / (27.0 * _HJS_C * (1.0 + 0.25 * s2))
          - zeta / (2.0 * _HJS_C))
    # sqrt(zeta) with a zero derivative at zeta = 0: there (s^2 = 0, a
    # uniform or an empty spin channel) zeta's own derivative is zero, and
    # the plain sqrt's infinite one would make the product NaN, as it does
    # in the JAX package; the value is the same everywhere
    pos = zeta > 0.0
    sqrt_z = torch.where(pos, torch.sqrt(torch.where(pos, zeta, 1.0)), 0.0)
    eg = (-0.4 * _HJS_C * ff * lam
          - (4.0 / 15.0) * _HJS_B * lam ** 2
          - 1.2 * _HJS_A * lam ** 3
          - 0.8 * np.sqrt(np.pi) * lam ** 3.5
          - 2.4 * lam ** 3.5 * (sqrt_z - torch.sqrt(eta)))
    nu2 = nu * nu
    chi = nu / torch.sqrt(lam + nu2)
    srt_l = torch.sqrt(nu2 + lam)
    srt_z = torch.sqrt(nu2 + zeta)
    srt_e = torch.sqrt(nu2 + eta)
    return (_HJS_A
            - (4.0 / 9.0) * _HJS_B / lam * (1.0 - chi)
            - (4.0 / 9.0) * _HJS_C * ff / lam ** 2
            * (1.0 - 1.5 * chi + 0.5 * chi ** 3)
            - (8.0 / 9.0) * eg / lam ** 3
            * (1.0 - 1.875 * chi + 1.25 * chi ** 3 - 0.375 * chi ** 5)
            + 2.0 * nu * (srt_z - srt_e)
            + 2.0 * zeta * torch.log((nu + srt_z) / (nu + srt_l))
            - 2.0 * eta * torch.log((nu + srt_e) / (nu + srt_l)))


def _wpbe_x(rho, sigma, tau=None, omega=0.11):
    """Short-range (erfc-screened) omega-PBE exchange energy density via
    spin scaling, HJS closed form.  HSE06 subtracts hyb_sr of this and
    adds the same fraction of short-range exact exchange."""
    r = _floor(2.0 * rho)
    sig = 4.0 * _ss(sigma)
    kf = (3.0 * np.pi ** 2 * r) ** (1.0 / 3.0)
    s2 = sig / _floor((2.0 * kf * r) ** 2)
    fx = _hjs_fx_sr(s2, omega / kf)
    return 0.5 * torch.sum(-_CX * r ** (4.0 / 3.0) * fx, dim=0)


def _pw92_c_term(rho, sigma, tau=None):
    return _pw92_c(rho)


# ---- VWN5 correlation (Vosko-Wilk-Nusair fit V) -----------------------

# (A, x0, b, c) of the Pade-log fit for the paramagnetic / ferromagnetic
# energies and the spin stiffness alpha_c (VWN table 5 / eq. [4.4])
_VWN5_EP = (0.0310907, -0.10498, 3.72744, 12.9352)
_VWN5_EF = (0.01554535, -0.32500, 7.06042, 18.0578)
_VWN5_AC = (-1.0 / (6.0 * np.pi ** 2), -0.00475840, 1.13107, 13.0045)


def _vwn_E(x, A, x0, b, c):
    """VWN eq. [4.4]: A{ln(x^2/X) + 2b/Q atan(Q/(2x+b))
    - b x0/X(x0) [ln((x-x0)^2/X) + 2(b+2x0)/Q atan(Q/(2x+b))]}."""
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = np.sqrt(4.0 * c - b * b)
    at = torch.atan(Q / (2.0 * x + b))
    return A * (torch.log(x * x / X) + 2.0 * b / Q * at
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X)
                                 + 2.0 * (b + 2.0 * x0) / Q * at))


def _vwn5_eps(rs, zeta):
    """VWN5 eps_c(rs, zeta) with the standard channel interpolation."""
    x = torch.sqrt(rs)
    ep = _vwn_E(x, *_VWN5_EP)
    ef = _vwn_E(x, *_VWN5_EF)
    ac = _vwn_E(x, *_VWN5_AC)
    fz, _, _ = _fz(zeta)
    z4 = zeta ** 4
    return ep + ac * (fz / _PW92_F2) * (1.0 - z4) + (ef - ep) * fz * z4


def _vwn5_c_term(rho, sigma, tau=None):
    rt, rs, zeta = _rs_zeta(rho)
    return rt * _vwn5_eps(rs, zeta)


# ---- B88 exchange -----------------------------------------------------

_B88_BETA = 0.0042


def _b88_x(rho, sigma, tau=None):
    """Full B88 exchange (Slater + gradient correction), spin-resolved."""
    r = _floor(rho)                             # (2, g)
    sig = _ss(sigma)                            # |grad rho_s|^2
    r43 = r ** (4.0 / 3.0)
    x2 = sig / (r43 * r43 / r)                  # x^2 = sig / rho^{8/3}
    # sqrt at sig = 0 would NaN the gradient; the clamp's is 0 below
    x = torch.sqrt(_max(x2, 1e-24 if r.dtype == torch.float64 else 1e-12))
    corr = -_B88_BETA * r43 * x2 \
        / (1.0 + 6.0 * _B88_BETA * x * torch.asinh(x))
    return _uniform_x(rho) + torch.sum(corr, dim=0)


# ---- LYP correlation (Miehlich closed form) ---------------------------

_LYP_A = 0.04918
_LYP_B = 0.132
_LYP_C = 0.2533
_LYP_D = 0.349
_CF = 0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)


def _lyp_c(rho, sigma, tau=None):
    """LYP correlation energy density, CPL 157, 200 (1989) eq. (2)."""
    ra, rb = _floor(rho[0]), _floor(rho[1])
    rt = ra + rb
    rm13 = rt ** (-1.0 / 3.0)
    den = 1.0 + _LYP_D * rm13
    om = torch.exp(-_LYP_C * rm13) / den * rt ** (-11.0 / 3.0)
    dl = _LYP_C * rm13 + _LYP_D * rm13 / den
    saa, sab, sbb = sigma
    st = saa + 2.0 * sab + sbb                  # |grad rho_total|^2
    pair = ra * rb
    brack = pair * (
        2.0 ** (11.0 / 3.0) * _CF * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
        + (47.0 / 18.0 - 7.0 * dl / 18.0) * st
        - (5.0 / 2.0 - dl / 18.0) * (saa + sbb)
        - (dl - 11.0) / 9.0 * (ra * saa + rb * sbb) / rt
    ) - 2.0 / 3.0 * rt * rt * st \
        + (2.0 / 3.0 * rt * rt - ra * ra) * sbb \
        + (2.0 / 3.0 * rt * rt - rb * rb) * saa
    return -4.0 * _LYP_A * pair / (den * rt) - _LYP_A * _LYP_B * om * brack


# ---- SCAN meta-GGA ----------------------------------------------------

_SCAN_K1 = 0.065
_SCAN_MU = 10.0 / 81.0
_SCAN_B2 = np.sqrt(5913.0 / 405000.0)
_SCAN_B1 = (511.0 / 13500.0) / (2.0 * _SCAN_B2)
_SCAN_B3 = 0.5
_SCAN_B4 = _SCAN_MU ** 2 / _SCAN_K1 - 1606.0 / 18225.0 - _SCAN_B1 ** 2
_SCAN_A1 = 4.9479
_SCAN_H0X = 1.174
_SCAN_B1C = 0.0285764
_SCAN_B2C = 0.0889
_SCAN_B3C = 0.125541
_SCAN_CHI = 0.128026                 # chi_infinity of g_inf(s^2)
_CKF2 = (3.0 * np.pi ** 2) ** (2.0 / 3.0)


def _ief(a, c1, c2, d):
    """SCAN iso-orbital interpolation: exp(-c1 a/(1-a)) for a < 1,
    -d exp(c2/(1-a)) for a > 1, 0 at a = 1.  The guarded denominators
    keep both branches' gradients free of NaN at the seam."""
    low = a < 1.0
    high = a > 1.0
    one = a.new_tensor(1.0)
    d1 = torch.where(low, 1.0 - a, one)
    d2 = torch.where(high, 1.0 - a, -one)
    f_low = torch.exp(-c1 * a / d1)
    f_high = -d * torch.exp(c2 / d2)
    return torch.where(low, f_low,
                       torch.where(high, f_high, a.new_tensor(0.0)))


def _scan_fx(p, alpha):
    """SCAN exchange enhancement Fx(p, alpha)."""
    x = _SCAN_MU * p * (1.0 + (_SCAN_B4 * p / _SCAN_MU)
                        * torch.exp(-abs(_SCAN_B4) * p / _SCAN_MU)) \
        + (_SCAN_B1 * p + _SCAN_B2 * (1.0 - alpha)
           * torch.exp(-_SCAN_B3 * (1.0 - alpha) ** 2)) ** 2
    h1 = 1.0 + _SCAN_K1 - _SCAN_K1 / (1.0 + x / _SCAN_K1)
    fx = _ief(alpha, 0.667, 0.8, 1.24)
    eps = 1e-20 if p.dtype == torch.float64 else 1e-10
    gx = -torch.expm1(-_SCAN_A1 * _max(p, eps) ** (-0.25))
    return (h1 + fx * (_SCAN_H0X - h1)) * gx


def _scan_x(rho, sigma, tau):
    """SCAN exchange via spin scaling on the (2 rho_s) channels."""
    r = _floor(2.0 * rho)
    sig = 4.0 * _ss(sigma)
    tt = _floor(2.0 * tau)
    p = sig / _floor(4.0 * _CKF2 * r ** (8.0 / 3.0))
    tau_w = sig / (8.0 * r)
    tau_u = 0.3 * _CKF2 * r ** (5.0 / 3.0)
    alpha = _max((tt - tau_w) / _floor(tau_u), 0.0)
    return 0.5 * torch.sum(-_CX * r ** (4.0 / 3.0) * _scan_fx(p, alpha),
                           dim=0)


def _scan_c(rho, sigma, tau):
    """SCAN correlation: eps1 + f_c(alpha) (eps0 - eps1)."""
    rt, rs, zeta = _rs_zeta(rho)
    sig_t = sigma[0] + 2.0 * sigma[1] + sigma[2]
    tt = torch.sum(_floor(tau), dim=0)
    omz = _floor(1.0 - zeta)
    opz = _floor(1.0 + zeta)
    ds_z = 0.5 * (opz ** (5.0 / 3.0) + omz ** (5.0 / 3.0))
    tau_w = sig_t / (8.0 * rt)
    tau_u = 0.3 * _CKF2 * ds_z * rt ** (5.0 / 3.0)
    alpha = _max((tt - tau_w) / _floor(tau_u), 0.0)
    # eps1: PBE-like with rs-dependent beta and the (1+4At^2)^{-1/4} g
    eps_lsda = _pw92_eps(rs, zeta)
    phi = 0.5 * (opz ** (2.0 / 3.0) + omz ** (2.0 / 3.0))
    kf = (3.0 * np.pi ** 2 * rt) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / np.pi)
    t2 = sig_t / _floor((2.0 * phi * ks * rt) ** 2)
    beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
    g3 = _PBE_GAMMA * phi ** 3
    w1 = torch.expm1(-eps_lsda / g3)            # exp(-eps/g3) - 1 >= 0
    aa = beta_rs / (_PBE_GAMMA * _floor(w1))
    g = (1.0 + 4.0 * aa * t2) ** (-0.25)
    h1 = g3 * torch.log1p(w1 * (1.0 - g))
    eps1 = eps_lsda + h1
    # eps0: LDA0 + H0, damped by Gc(zeta) (zero at |zeta| = 1: SCAN is
    # one-electron self-correlation-free through this factor)
    eps_lda0 = -_SCAN_B1C / (1.0 + _SCAN_B2C * torch.sqrt(rs)
                             + _SCAN_B3C * rs)
    w0 = torch.expm1(-eps_lda0 / _SCAN_B1C)
    s2 = sig_t / _floor(4.0 * _CKF2 * rt ** (8.0 / 3.0))
    ginf = (1.0 + 4.0 * _SCAN_CHI * s2) ** (-0.25)
    h0 = _SCAN_B1C * torch.log1p(w0 * (1.0 - ginf))
    dx_z = 0.5 * (opz ** (4.0 / 3.0) + omz ** (4.0 / 3.0))
    gc = (1.0 - 2.3631 * (dx_z - 1.0)) * (1.0 - zeta ** 12)
    eps0 = (eps_lda0 + h0) * gc
    fc = _ief(alpha, 0.64, 1.5, 0.7)
    return rt * (eps1 + fc * (eps0 - eps1))


_TERMS = {
    "slater": (_lda_x_term, 0),
    "pw92": (_pw92_c_term, 0),
    "vwn5": (_vwn5_c_term, 0),
    "pbex": (_pbe_x, 1),
    "pbec": (_pbe_c, 1),
    # SR omega-PBE exchange at the HSE06 screening
    "wpbexhse": (partial(_wpbe_x, omega=0.11), 1),
    "b88": (_b88_x, 1),
    "lyp": (_lyp_c, 1),
    "scanx": (_scan_x, 2),
    "scanc": (_scan_c, 2),
}


# ----------------------------------------------------------------------
# functional registry

@dataclass(frozen=True)
class XCSpec:
    """Functional description: its exact-exchange fractions and its
    (coefficient, term name) sum."""
    name: str
    hyb: float                       # exact-exchange fraction (full-range)
    terms: tuple                     # ((coeff, term_name), ...)
    hyb_sr: float = 0.0              # SHORT-RANGE exact-exchange fraction
    omega: float = 0.0               # range-separation parameter (bohr^-1)
                                     # of the hyb_sr erfc-screened exchange

    @property
    def is_gga(self):
        """Needs density gradients (true for GGA and meta-GGA terms)."""
        return any(_TERMS[t][1] >= 1 for _, t in self.terms)

    @property
    def is_mgga(self):
        """Needs the kinetic-energy density tau."""
        return any(_TERMS[t][1] >= 2 for _, t in self.terms)


_FUNCTIONALS = {
    # 'lda' = Slater exchange + PW92 correlation
    "lda": XCSpec("lda", 0.0, ((1.0, "slater"), (1.0, "pw92"))),
    "lda,pw92": XCSpec("lda", 0.0, ((1.0, "slater"), (1.0, "pw92"))),
    "slater": XCSpec("slater", 0.0, ((1.0, "slater"),)),
    "pw92": XCSpec("pw92", 0.0, ((1.0, "pw92"),)),
    "pbe": XCSpec("pbe", 0.0, ((1.0, "pbex"), (1.0, "pbec"))),
    "pbex": XCSpec("pbex", 0.0, ((1.0, "pbex"),)),
    "pbec": XCSpec("pbec", 0.0, ((1.0, "pbec"),)),
    "pbe0": XCSpec("pbe0", 0.25, ((0.75, "pbex"), (1.0, "pbec"))),
    "vwn5": XCSpec("vwn5", 0.0, ((1.0, "vwn5"),)),
    "vwn": XCSpec("vwn5", 0.0, ((1.0, "vwn5"),)),
    "b88": XCSpec("b88", 0.0, ((1.0, "b88"),)),
    "lyp": XCSpec("lyp", 0.0, ((1.0, "lyp"),)),
    "blyp": XCSpec("blyp", 0.0, ((1.0, "b88"), (1.0, "lyp"))),
    # 0.72 (slater + dB88) + 0.08 slater == 0.80 slater + 0.72 dB88
    "b3lyp": XCSpec("b3lyp", 0.2, ((0.72, "b88"), (0.08, "slater"),
                                   (0.81, "lyp"), (0.19, "vwn5"))),
    "scan": XCSpec("scan", 0.0, ((1.0, "scanx"), (1.0, "scanc"))),
    "scanx": XCSpec("scanx", 0.0, ((1.0, "scanx"),)),
    "scanc": XCSpec("scanc", 0.0, ((1.0, "scanc"),)),
    # SCAN0: 25% exact exchange on the SCAN base (Hui & Chai, JCP 2016)
    "scan0": XCSpec("scan0", 0.25, ((0.75, "scanx"), (1.0, "scanc"))),
    # HSE06 (Krukau et al., JCP 125, 224106 (2006)): PBE + 0.25 (SR-HF(omega)
    # - SR-PBE(omega)), omega = 0.11 bohr^-1; the erfc-screened exchange is
    # served from the same ISDF basis (get_jk(dm, omega=-0.11)) and is
    # finite at q+G = 0, so no exxdiv correction applies to it
    "hse06": XCSpec("hse06", 0.0, ((1.0, "pbex"), (-0.25, "wpbexhse"),
                                   (1.0, "pbec")),
                    hyb_sr=0.25, omega=0.11),
    "wpbexhse": XCSpec("wpbexhse", 0.0, ((1.0, "wpbexhse"),)),
    "hf": XCSpec("hf", 1.0, ()),
}


def parse_xc(xc) -> XCSpec:
    if isinstance(xc, XCSpec):
        return xc
    key = str(xc).strip().lower().replace("-", "").replace(" ", "")
    if key not in _FUNCTIONALS:
        raise NotImplementedError(
            f"xc={xc!r}: available {sorted(set(_FUNCTIONALS))}")
    return _FUNCTIONALS[key]


# ----------------------------------------------------------------------
# grid evaluation

def _exc_density(rho, sigma, spec, tau=None):
    e = 0.0
    for coeff, name in spec.terms:
        fn, _kind = _TERMS[name]
        e = e + coeff * fn(rho, sigma, tau)
    return e


def _grad_fft(rho, gvt, fmesh):
    """FFT gradient of real (2, ng) densities -> (2, 3, ng)."""
    cdt = torch.complex64 if rho.dtype == torch.float32 else torch.complex128
    rg = fft3(rho.to(cdt), fmesh)
    return torch.stack([ifft3(1j * gvt[i] * rg, fmesh).real
                        for i in range(3)], dim=1)


def _sigma(r, gvt, fmesh):
    g = _grad_fft(r, gvt, fmesh)
    return torch.stack([torch.sum(g[0] * g[0], dim=0),
                        torch.sum(g[0] * g[1], dim=0),
                        torch.sum(g[1] * g[1], dim=0)])


def _exc_total(r, t, gv, spec, fmesh, weight):
    sigma = _sigma(r, gv.T, fmesh) if spec.is_gga else None
    return weight * torch.sum(_exc_density(r, sigma, spec, tau=t))


def exc_and_vxc(rho, gv, spec, fmesh, weight):
    """Total xc energy and potential on the grid.

    rho: (2, ng) real spin densities; gv: (ng, 3) reciprocal vectors of the
    mesh (a tensor on rho's device); fmesh: 3-tuple; weight: vol/ng.
    Returns (exc 0-d tensor, vxc (2, ng)).  vxc is the autograd gradient of
    the discrete exc with respect to the grid values, divided by the
    weight, so sum(vxc * drho) * weight == dExc to machine precision."""
    if spec.is_mgga:
        raise NotImplementedError(
            f"xc={spec.name!r} is tau-dependent: use exc_and_vxc_mgga "
            "(the caller must supply the kinetic-energy density)")
    if not spec.terms:                              # pure exact exchange
        return rho.new_zeros(()), torch.zeros_like(rho)
    with torch.enable_grad():
        r = rho.detach().requires_grad_(True)
        exc = _exc_total(r, None, gv, spec, fmesh, weight)
        (de,) = torch.autograd.grad(exc, r)
    return exc.detach(), de / weight


def exc_and_vxc_mgga(rho, tau, gv, spec, fmesh, weight):
    """Meta-GGA xc energy and potential pair on the grid.

    rho, tau: (2, ng) real spin densities and kinetic-energy densities
    (tau = 1/2 sum_occ |grad psi|^2 per spin).  Returns (exc, v_rho (2, ng),
    v_tau (2, ng)): both are autograd gradients of the same discrete Exc,
    so sum(v_rho drho + v_tau dtau) * weight == dExc to machine
    precision."""
    with torch.enable_grad():
        r = rho.detach().requires_grad_(True)
        t = tau.detach().requires_grad_(True)
        exc = _exc_total(r, t, gv, spec, fmesh, weight)
        dr, dt = torch.autograd.grad(exc, (r, t), allow_unused=True)
    dr = torch.zeros_like(rho) if dr is None else dr
    dt = torch.zeros_like(tau) if dt is None else dt
    return exc.detach(), dr / weight, dt / weight


def bloch_ao_grad(ao, kpts, coords, gv, fmesh, angle=None):
    """Spatial gradients of Bloch AOs via the mesh FFT.

    grad phi_k = e^{ikr} (grad + ik) u_k with u_k = e^{-ikr} phi_k the
    periodic part, grad u_k exact for the band-limited mesh representation
    (the choice of the FFT density gradient).

    ao: (nk, ng, nao) complex; kpts: (nk, 3); coords, gv: (ng, 3), all
    tensors on ao's device.  Returns (3, nk, ng, nao).  ``angle``: optional
    precomputed k.r phase angles (ng, nk)."""
    if angle is None:
        angle = coords @ kpts.T
    ph = torch.exp(-1j * angle).to(ao.dtype)                 # (ng, nk)
    u = (ao * ph.T[:, :, None]).transpose(1, 2)              # (nk, nao, ng)
    ug = fft3(u, fmesh)
    out = []
    for i in range(3):
        du = ifft3(1j * gv[:, i] * ug, fmesh)
        dphi = du + 1j * kpts[:, i][:, None, None].to(ao.dtype) * u
        out.append(dphi.transpose(1, 2) * ph.conj().T[:, :, None])
    return torch.stack(out)


def get_tau(dphi, dm, nk):
    """Spin kinetic-energy densities from k-point density matrices.

    dphi: (3, nk, ng, nao) Bloch AO gradients; dm: (nspin, nk, nao, nao).
    tau_s(r) = 1/(2 nk) sum_i sum_mn D_mn dphi_i,m dphi_i,n^*: the index
    pairing of :func:`get_rho`."""
    tau = 0.0
    for i in range(dphi.shape[0]):
        tau = tau + get_rho(dphi[i], dm, nk)
    return 0.5 * tau


def vtau_matrix(dphi, vt, weight):
    """AO Fock matrix of the tau-channel potential:
    (weight/2) sum_i <grad_i phi_m | v_tau | grad_i phi_n>."""
    out = 0.0
    for i in range(dphi.shape[0]):
        out = out + vxc_matrix(dphi[i], vt, weight)
    return 0.5 * out


def get_rho(ao, dm, nk):
    """Spin densities on the grid from k-point density matrices.

    ao: (nk, ng, nao) complex; dm: (nspin, nk, nao, nao) complex.
    n(r) = (1/nk) sum_k dm_mn phi_m conj(phi_n), the convention of
    ``pw.jk.get_j_kpts``.  (nspin, ng), streamed over k-blocks."""
    nspin = dm.shape[0]
    rho = torch.zeros((nspin, ao.shape[1]), dtype=ao.real.dtype,
                      device=ao.device)
    for ks in _k_blocks(ao, 2 * nspin):
        a = ao[ks]
        rho += ((a @ dm[:, ks]) * a.conj()).real.sum(dim=(1, 3))
    return rho / nk


def vxc_matrix(ao, v, weight):
    """AO matrix of a real grid potential, per spin channel.

    ao: (nk, ng, nao); v: (nspin, ng) -> (nspin, nk, nao, nao):
    weight * (ao v)^H ao per k, streamed over k-blocks."""
    nspin = v.shape[0]
    nk, _, nao = ao.shape
    out = torch.empty((nspin, nk, nao, nao), dtype=ao.dtype,
                      device=ao.device)
    vc = v.to(ao.dtype)
    for ks in _k_blocks(ao, 1):
        a = ao[ks]
        for s in range(nspin):
            out[s, ks] = (a * vc[s, :, None]).mH @ a
    return weight * out


def _k_blocks(ao, ntemp):
    """k-slices of ``ao`` whose ``ntemp`` (ng, nao) temporaries a k-point
    fit into a quarter of the device's free memory; their number is added
    to the counter ``scf.xc_kblocks``."""
    nk, ng, nao = ao.shape
    per_k = max(1, ntemp * ng * nao * ao.element_size())
    kb = int(max(1, min(nk, free_memory_bytes(ao.device) // (4 * per_k))))
    blocks = [slice(k0, min(nk, k0 + kb)) for k0 in range(0, nk, kb)]
    profiling.count("scf.xc_kblocks", len(blocks))
    return blocks


def _spin_pair(x, nspin):
    """(2, ng) channels of a (nspin, ng) grid field: a restricted caller's
    total becomes half in each channel."""
    return torch.cat([x, x]) * 0.5 if nspin == 1 else x


def xc_pass(ao, dm, gv, spec, fmesh, weight, nk, nspin, coords=None,
            kpts=None, matrices=True):
    """One pass from density matrices to the xc energy and potential.

    ao: (nk, ng, nao); dm: (nspin, nk, nao, nao) (restricted callers pass
    the total density with nspin = 1).  Returns (exc, vxc (nspin, nk, nao,
    nao) or None, nelec, v (nspin, ng), v_tau (nspin, ng) or None), the
    scalars as 0-d tensors.  With ``matrices`` False only the grid
    potentials are formed.  For a meta-GGA the AO gradients are made block
    by block, twice (for tau and for the v_tau matrix), so that (3, nk, ng,
    nao) never exists; the matrices carry the generalised-KS tau term."""
    rho = _spin_pair(get_rho(ao, dm, nk), nspin)
    nelec = rho.sum() * weight
    vt = None
    if spec.is_mgga:
        tau = torch.zeros((nspin, ao.shape[1]), dtype=rho.dtype,
                          device=rho.device)
        for ks in _k_blocks(ao, 8 * nspin):
            dphi = bloch_ao_grad(ao[ks], kpts[ks], coords, gv, fmesh)
            tau += get_tau(dphi, dm[:, ks], 1.0)
        exc, v, vt = exc_and_vxc_mgga(rho, _spin_pair(tau / nk, nspin), gv,
                                      spec, fmesh, weight)
        vt = vt[:nspin]
    else:
        exc, v = exc_and_vxc(rho, gv, spec, fmesh, weight)
    v = v[:nspin]          # both channels identical for restricted
    vxc = None
    if matrices:
        vxc = band_vxc(ao, v, weight, vt=vt, kpts_b=kpts, coords=coords,
                       gv=gv, fmesh=fmesh)
    return exc, vxc, nelec, v, vt


def band_vxc(aob, v, weight, vt=None, kpts_b=None, coords=None, gv=None,
             fmesh=None):
    """AO matrices (nspin, nb, nao, nao) of grid potentials at the
    k-points of ``aob``: ``vxc_matrix`` plus, with ``vt``, the tau term
    from the AO gradients, made block by block."""
    out = vxc_matrix(aob, v, weight)
    if vt is not None:
        nspin = v.shape[0]
        for ks in _k_blocks(aob, 8 * nspin):
            dphi = bloch_ao_grad(aob[ks], kpts_b[ks], coords, gv, fmesh)
            out[:, ks] += vtau_matrix(dphi, vt, weight)
    return out
