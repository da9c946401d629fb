"""The plain reference of a KUKS-PBE+U answer on an ISDF state, written
from the definitions, in plain torch.  A mix names it with
``"reference": "uks"``.

For one geometry (``system.System``: the Bloch functions on the mesh,
the one-electron matrices, the Ewald energy) the energy functional is

    E[D] = Tr(D h)/nk + 1/2 Tr(D J)/nk + E_xc[rho_a, rho_b] + E_U[D] + E_nuc

with D = (D^a, D^b) over the k-points and, per spin, the Fock matrix
F^s = h + J + V_xc^s + V_U^s, each potential the derivative of its
energy in the pairing E = sum_k Tr(D_k V_k)/nk.

- J: interpolation points as ``uhf.py`` selects them
  (``uhf.select_points``), and the least squares fit of the q = 0 pair
  densities conj(phi_k,mu) phi_k,nu by zeta_I(r) conj(x_k,I,mu)
  x_k,I,nu with the configuration's ``fit_ridge``; the metric
  M^0_IJ = int int zeta_I(r) v(r - r') zeta_J(r') by the FFT,
  v(G) = 4 pi / |G|^2 and nothing at G = 0.  rho_I = sum_s sum_k
  (x_k D^s_k x_k^H)_II / nk, J_k = x_k^H diag(M^0 rho) x_k.  A pure
  functional reads no exchange, so only the q = 0 sector is fitted.
- E_xc: spin-polarised PBE (Perdew, Burke, Ernzerhof, PRL 77, 3865
  (1996)) with PW92 correlation underneath (Perdew, Wang, PRB 45, 13244
  (1992), Table I, p = 1).  Exchange by spin scaling,
  E_x[n_a, n_b] = (E_x[2 n_a] + E_x[2 n_b]) / 2, with
  e_x = -(3/4)(3/pi)^(1/3) n^(4/3) F_x(s), s = |grad n| / (2 k_F n),
  F_x = 1 + kappa - kappa / (1 + mu s^2 / kappa); correlation
  n (eps_c^unif(r_s, zeta) + H(r_s, zeta, t)).
- The discretisation: rho_s(r) = sum_k sum_mu,nu D^s_k,mu,nu
  phi_k,mu(r) conj(phi_k,nu(r)) / nk from the Bloch functions on the FFT
  mesh (63^3 at the production cut-off), grad rho_s by spectral
  differentiation (the FFT, i G, the inverse FFT), E_xc = w sum_r
  e(rho_a, rho_b, sigma) with w = vol / ng, and the potential
  v_s(r) = (dE_xc / d rho_s(r)) / w, the derivative of that discrete
  E_xc (autograd), so that V_xc^s_k = w phi_k^H diag(v_s) phi_k.
- E_U: Dudarev's simplified +U (PRB 57, 1505 (1998)) on each site
  {atom: (l, U)} of the configuration: n^s = mean_k[S_k^1/2 D^s_k
  S_k^1/2] on the atom's first radial function of its first l shell,
  made Hermitian, E_U = sum_I (U/2) sum_s Tr(n^s - n^s n^s), and
  V_U^s_k = S_k^1/2 P^T (U/2)(1 - 2 n^s) P S_k^1/2.
- Fermi-smeared occupations at fixed spin counts, time reversal kept,
  and a Pulay DIIS iteration from the program's density to
  |dE| < 1e-11 Ha, as ``uhf.py`` does them.

Work on the mesh goes in blocks of mesh rows of at most ``BLOCK_BYTES``,
so that the reference fits on a card that holds nothing else (the run
releases the program's state first): at the production size the Bloch
functions on the mesh take 15.9 GB and the fit's zeta 9.9 GB.

Departures from the published methods: the basis and the pseudopotential
of Ni are the repo's own (``tables.json``, as for ``uhf.py``); the +U
projectors are Loewdin-orthogonalised atomic functions, not the PAW
projectors of the Materials Project's U; the density is floored at
``FLOOR`` (and 1 +- zeta too) where the formulas divide by it, which the
NiO mesh never reaches; the Coulomb term is the ISDF fit's, as the
program's is.

An answer is judged as ``uhf.py`` judges one: ``energy_gap``
|E_program - E_reference| per atom and ``moment_gap``, the largest
difference of an atom's Mulliken spin moment, against the fixed point
reached from the program's density."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.reference import uhf
from benchmark.reference.system import C128, F64

BLOCK_BYTES = 1 << 30     # the mesh rows of one pass over the k-points
FLOOR = 1e-12             # density (and 1 +- zeta) floor of the formulas

# PBE (PRL 77, 3865): kappa, beta and gamma = (1 - ln 2) / pi^2 of the
# correlation as printed; mu = beta pi^2 / 3 (printed 0.21951) with beta to
# the full precision of the authors' own routine, 0.06672455060314922
KAPPA = 0.804
BETA = 0.066725
GAMMA = (1.0 - math.log(2.0)) / math.pi ** 2
MU = 0.06672455060314922 * math.pi ** 2 / 3.0
# PW92 (PRB 45, 13244) Table I: (A, alpha_1, beta_1, beta_2, beta_3, beta_4)
# of eps_c(r_s, 0), eps_c(r_s, 1) and -alpha_c(r_s)
PW92_P = (0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
PW92_F = (0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
PW92_A = (0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
F2_0 = 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))      # f''(0) of PW92 eq. (9)


def pw92_g(rs, a, a1, b1, b2, b3, b4):
    """PW92 eq. (10) with p = 1."""
    den = 2.0 * a * (b1 * rs.sqrt() + b2 * rs + b3 * rs ** 1.5 + b4 * rs ** 2)
    return -2.0 * a * (1.0 + a1 * rs) * torch.log(1.0 + 1.0 / den)


def pw92_eps(rs, zeta):
    """The uniform gas's correlation energy per electron eps_c(r_s, zeta),
    PW92 eq. (8)."""
    f = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) \
        / (2.0 ** (4.0 / 3.0) - 2.0)
    e0, e1 = pw92_g(rs, *PW92_P), pw92_g(rs, *PW92_F)
    alpha = -pw92_g(rs, *PW92_A)
    z4 = zeta ** 4
    return e0 + alpha * f / F2_0 * (1.0 - z4) + (e1 - e0) * f * z4


def pbe_x(n, grad2):
    """PBE exchange energy per volume of an unpolarised density ``n`` with
    |grad n|^2 = ``grad2``."""
    n = n.clamp_min(FLOOR)
    kf = (3.0 * math.pi ** 2 * n) ** (1.0 / 3.0)
    s2 = grad2 / (2.0 * kf * n) ** 2
    fx = 1.0 + KAPPA - KAPPA / (1.0 + MU * s2 / KAPPA)
    return -0.75 * (3.0 / math.pi) ** (1.0 / 3.0) * n ** (4.0 / 3.0) * fx


def pbe_c(na, nb, grad2):
    """PBE correlation energy per volume of the spin densities with
    |grad (na + nb)|^2 = ``grad2``."""
    n = (na + nb).clamp_min(FLOOR)
    zeta = (na - nb) / n
    opz, omz = (1.0 + zeta).clamp_min(FLOOR), (1.0 - zeta).clamp_min(FLOOR)
    rs = (3.0 / (4.0 * math.pi * n)) ** (1.0 / 3.0)
    eps = pw92_eps(rs, zeta)
    phi = 0.5 * (opz ** (2.0 / 3.0) + omz ** (2.0 / 3.0))
    kf = (3.0 * math.pi ** 2 * n) ** (1.0 / 3.0)
    ks = (4.0 * kf / math.pi).sqrt()
    t2 = grad2 / (2.0 * phi * ks * n) ** 2
    g3 = GAMMA * phi ** 3
    a = (BETA / GAMMA) / torch.expm1(-eps / g3).clamp_min(FLOOR)
    at2 = a * t2
    h = g3 * torch.log(1.0 + (BETA / GAMMA) * t2 * (1.0 + at2)
                       / (1.0 + at2 + at2 * at2))
    return n * (eps + h)


def projector_columns(sy, atom, l):
    """Columns of atom ``atom``'s first radial function of its first
    ``l`` shell, one per m (the AO order of ``system.py``: within a
    shell m-major, contractions minor)."""
    a0, a1 = sy.atom_ao[atom]
    col = 0
    for f in sy.shells:
        if a0 <= col < a1 and f.l == l:
            nctr = f.coeffs.shape[1]
            return np.array([col + m * nctr for m in range(2 * l + 1)])
        col += f.nfunc
    raise ValueError(f"atom {atom} has no l = {l} shell")


class Reference(uhf.Reference):
    """The reference state of one geometry (lattice and atoms in bohr)."""

    def __init__(self, cfg, geometry, device):
        scf = cfg["scf"]
        if str(scf.get("xc", "")).lower() != "pbe":
            raise NotImplementedError(f"xc {scf.get('xc')!r}: the reference "
                                      "is PBE")
        super().__init__(cfg, geometry, device)    # keeps self.phi
        t0 = time.perf_counter()
        sy = self.sys
        self.weight = sy.vol / sy.ngrid
        self.gv = torch.as_tensor(sy.gvectors(), dtype=F64, device=device)
        se, sv = torch.linalg.eigh(self.s1e)
        self.shalf = (sv * se.clamp_min(0.0).sqrt()[:, None, :].to(C128)
                      ) @ sv.mH
        self.sites = [(torch.as_tensor(projector_columns(sy, int(a), int(l)),
                                       device=device), float(u))
                      for a, (l, u) in sorted((int(a), v) for a, v in
                                              scf.get("hubbard", {}).items())]
        self.seconds["ks"] = time.perf_counter() - t0

    def _metric(self, phi, ridge):
        """M^0 (1, nip, nip), the q = 0 sector's metric, the only one J
        reads; the Bloch functions on the mesh ``phi`` are kept for
        E_xc."""
        self.phi = phi
        sy, x, dev = self.sys, self.x, self.device
        nk, ng, _ = phi.shape
        gram = x @ x.mH                                    # A_k = x_k x_k^H
        c = (gram.conj() * gram).sum(0)                    # normal matrix
        d = torch.diagonal(c).real ** -0.5
        eye = torch.eye(self.nip, dtype=C128, device=dev)
        chol = torch.linalg.cholesky(d[:, None] * c * d[None, :]
                                     + ridge * eye)
        z = torch.empty((ng, self.nip), dtype=C128, device=dev)
        rows = max(1, BLOCK_BYTES // (2 * nk * self.nip * 16))
        for i0 in range(0, ng, rows):
            a = phi[:, i0:i0 + rows] @ x.conj().transpose(1, 2)
            z[i0:i0 + rows] = (a.conj() * a).sum(0)
            del a
        z *= d[None, :]
        z = torch.linalg.solve_triangular(chol.mH, z, upper=True, left=False)
        z = torch.linalg.solve_triangular(chol, z, upper=False, left=False)
        z *= d[None, :]                                     # zeta (ng, nip)
        gv = torch.as_tensor(sy.gvectors(), dtype=F64, device=dev)
        g2 = (gv * gv).sum(1)
        v = torch.where(g2 > 1e-12, 4.0 * math.pi / g2.clamp_min(1e-12), 0.0)
        scale = torch.sqrt(v * sy.vol) / ng
        for c0 in range(0, self.nip, 128):
            blk = z[:, c0:c0 + 128].T.contiguous()
            z[:, c0:c0 + 128] = (sy.fft(blk) * scale).T
        m = z.T @ z.conj()
        # real zeta and a mesh symmetric in G: M^0 is real (time reversal)
        return m.real.to(C128)[None]

    # -- the functional -----------------------------------------------
    def get_j(self, dm):
        """J (nk, nao, nao) of the total density from the q = 0 fit."""
        x = self.x
        rho = ((x @ dm.sum(0)) * x.conj()).sum(-1).real.sum(0) / self.nk
        v = self.metric[0].real @ rho
        return x.mH @ (v[None, :, None].to(C128) * x)

    def rho_grid(self, dm):
        """The spin densities on the mesh, (2, ng) real."""
        phi = self.phi
        nk, ng, nao = phi.shape
        rho = torch.empty((2, ng), dtype=F64, device=self.device)
        rows = max(1, BLOCK_BYTES // (3 * nk * nao * 16))
        for i0 in range(0, ng, rows):
            p = phi[:, i0:i0 + rows]                      # (nk, b, nao)
            rho[:, i0:i0 + rows] = ((p @ dm) * p.conj()).real.sum((1, 3))
        return rho / nk

    def gradient(self, f):
        """Spectral gradient of real fields ``f`` (..., ng): (..., 3, ng)."""
        fg = self.sys.fft(f.to(C128))
        return torch.stack([self.sys.ifft(1j * self.gv[:, i] * fg).real
                            for i in range(3)], -2)

    def exc_and_v(self, rho):
        """(E_xc, v (2, ng)) of the spin densities on the mesh."""
        with torch.enable_grad():
            r = rho.detach().requires_grad_(True)
            g = self.gradient(r)                           # (2, 3, ng)
            ga, gb = g[0], g[1]
            e = (0.5 * pbe_x(2.0 * r[0], 4.0 * (ga * ga).sum(0))
                 + 0.5 * pbe_x(2.0 * r[1], 4.0 * (gb * gb).sum(0))
                 + pbe_c(r[0], r[1], ((ga + gb) ** 2).sum(0)))
            exc = self.weight * e.sum()
            (de,) = torch.autograd.grad(exc, r)
        return float(exc.detach()), de / self.weight

    def vxc_matrices(self, v):
        """V_xc^s_k = w phi_k^H diag(v_s) phi_k: (2, nk, nao, nao)."""
        phi = self.phi
        nk, ng, nao = phi.shape
        out = torch.zeros((2, nk, nao, nao), dtype=C128, device=self.device)
        rows = max(1, BLOCK_BYTES // (2 * nk * nao * 16))
        for i0 in range(0, ng, rows):
            p = phi[:, i0:i0 + rows]
            for s in (0, 1):
                vp = p * v[s, i0:i0 + rows, None].to(C128)
                out[s] += p.mH @ vp
        return self.weight * out

    def hubbard(self, dm):
        """(E_U, V_U (2, nk, nao, nao)) of Dudarev's +U."""
        sd = (self.shalf @ dm @ self.shalf).mean(1)        # (2, nao, nao)
        e_u = 0.0
        g = torch.zeros_like(sd)
        for idx, u in self.sites:
            n = sd[:, idx[:, None], idx[None, :]]
            n = 0.5 * (n + n.mH)
            eye = torch.eye(len(idx), dtype=C128, device=self.device)
            for s in (0, 1):
                e_u += 0.5 * u * float((torch.trace(n[s])
                                        - torch.trace(n[s] @ n[s])).real)
                g[s, idx[:, None], idx[None, :]] += 0.5 * u * (eye
                                                               - 2.0 * n[s])
        return e_u, self.shalf @ g[:, None] @ self.shalf

    def fock_energy(self, dm):
        """(fock (2, nk, nao, nao), total energy) at the spin density."""
        vj = self.get_j(dm)
        exc, v = self.exc_and_v(self.rho_grid(dm))
        vxc = self.vxc_matrices(v)
        e_u, vu = self.hubbard(dm)
        h = self.h1e
        dmt = dm.transpose(-1, -2)
        e = ((dmt * h).sum() + 0.5 * (dmt * vj).sum()).real / self.nk
        return h + vj + vxc + vu, float(e) + exc + e_u + self.e_nuc
