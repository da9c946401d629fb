"""The plain reference of a KUHF answer on an ISDF state, written from
the definitions, in plain torch.  A mix names it with ``"reference":
"uhf"``.

For one geometry (``system.System``: the Bloch functions on the mesh,
the one-electron matrices, the Ewald energy):

- interpolation points: a greedy pivoted Cholesky of the pair Gram
  matrix G_IJ = |sum_k sum_mu phi_k,mu(r_I) conj(phi_k,mu(r_J))|^2 / nk
  over the uniform pool ``m0``, stopped at nao c0 points or where the
  largest residual falls to n eps of the largest diagonal; residuals
  within that of the largest are a tie, taken at the lowest index;
- fitting vectors: for each momentum sector q (the k-points' own
  vectors), the least squares fit of every pair density
  conj(phi_k,mu) phi_k+q,nu on the mesh by zeta_I(r) conj(x_k,I,mu)
  x_k+q,I,nu, x_k = phi_k at the points: zeta C = Z with the normal
  matrix C and the right-hand side Z, solved with the Jacobi-scaled
  Tikhonov term ``fit_ridge`` of the configuration;
- the Coulomb metric M^q_IJ = int int zeta_I(r) v(r - r') conj(zeta_J(r'))
  by the FFT, v(G+q) = 4 pi / |G+q|^2 and nothing at G+q = 0, made to
  keep time reversal (M^-q = conj(M^q)) as the exact metric does;
- J and K of a density from the fitted pair densities, the UHF energy,
  Fermi-smeared occupations at fixed spin counts, time reversal kept
  (D_-k = conj(D_k)), and a Pulay DIIS iteration to a tight fixed point.

An answer (the program's converged energy and density) is judged by
two numbers: ``energy_gap``, |E_program - E_reference| per atom, with
E_reference the fixed point reached from the program's density; and
``moment_gap``, the largest difference of an atom's Mulliken spin
moment between the program's density and that fixed point.  The
program's density is read only to start from it and to judge it."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.reference.system import C128, F64, System

OVLP_CUTOFF = 1e-10     # overlap eigenvalues below this share are dropped
MAX_CYCLE = 60
DIIS_SPACE = 8
E_TOL = 1e-11           # Ha: the reference's own stop, far below any limit
DM_TOL = 1e-7
BLOCK_BYTES = 1 << 30   # the mesh rows of one pass over the k-points


def as_tensor(m, device):
    """A density (numpy or torch) as complex128 on ``device``."""
    if not torch.is_tensor(m):
        m = torch.as_tensor(np.asarray(m))
    return m.to(device=device, dtype=C128)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def k_index(kfrac, target):
    """Index of each fractional k-point ``target`` (n, 3) in ``kfrac``
    modulo whole reciprocal vectors."""
    d = target[:, None, :] - kfrac[None, :, :]
    hit = np.all(np.abs(d - np.round(d)) < 1e-8, axis=-1)
    assert hit.sum(1).min() == 1
    return hit.argmax(1)


def select_points(x, nip_max):
    """Greedy pivoted Cholesky of the pair Gram matrix of the pool values
    ``x`` (nk, npool, nao): the pivots, in order.  Candidates within
    n eps of the largest diagonal of the largest residual are equal to
    working precision; the lowest index among them is taken."""
    nk, n, _ = x.shape
    g = torch.einsum("kia,kja->ij", x, x.conj())
    a = g.abs() ** 2 / nk
    d = torch.diagonal(a).clone()
    tol = n * torch.finfo(F64).eps * float(d.max())
    lcols = torch.zeros((n, nip_max), dtype=F64, device=x.device)
    piv = []
    for j in range(nip_max):
        p = int(torch.argmax((d >= d.max() - tol).to(torch.int8)))
        if float(d[p]) <= tol:
            break
        col = (a[:, p] - lcols[:, :j] @ lcols[p, :j]) / math.sqrt(float(d[p]))
        lcols[:, j] = col
        d -= col * col
        d[p] = -math.inf
        piv.append(p)
    return piv


class Reference:
    """The reference state of one geometry (lattice and atoms in bohr)."""

    def __init__(self, cfg, geometry, device):
        t0 = time.perf_counter()
        sy = System(cfg, *geometry, device)
        self.sys, self.device, self.nk = sy, device, sy.nk
        phi = sy.bloch(sy.grid())                           # (nk, ng, nao)
        self.s1e, self.h1e = sy.one_electron(phi)
        self.e_nuc = sy.ewald()
        sync(device)
        t1 = time.perf_counter()
        pool = sy.bloch(sy.grid(tuple(cfg["m0"])))
        piv = select_points(pool, int(sy.nao * float(cfg["c0"])))
        self.x = pool[:, piv].contiguous()                  # (nk, nip, nao)
        del pool
        self.nip = len(piv)
        self.metric = self._metric(phi, float(cfg["fit_ridge"]))
        del phi
        sync(device)
        self.seconds = {"one_electron": t1 - t0,
                        "isdf": time.perf_counter() - t1}
        # the sector of each pair: qk[k, k'] = k' - k
        kf = sy.kfrac
        self.qk = np.stack([k_index(kf, kf - kf[k]) for k in range(sy.nk)])
        self.minus_k = torch.as_tensor(k_index(kf, -kf), device=device)
        self.h1e = self.time_reversed(self.h1e)
        na = sy.nelectron // 2
        self.nocc = (na, sy.nelectron - na)
        self.sigma = float(cfg["scf"]["smearing"])
        se, sv = torch.linalg.eigh(self.s1e)
        self.keep = se > OVLP_CUTOFF * se.amax(dim=-1, keepdim=True)
        self.orth = sv * torch.where(self.keep, se.clamp_min(1e-300) ** -0.5,
                                     0.0)[:, None, :].to(C128)

    def _metric(self, phi, ridge):
        """M^q (nk, nip, nip) of every sector q."""
        sy, x = self.sys, self.x
        nk, ng, nao = phi.shape
        dev = self.device
        r = torch.as_tensor(sy.grid(), dtype=F64, device=dev)
        gv = torch.as_tensor(sy.gvectors(), dtype=F64, device=dev)
        kq = np.stack([k_index(sy.kfrac, sy.kfrac[k] + sy.kfrac)
                       for k in range(nk)])
        gram = x @ x.mH                                    # A_k = x_k x_k^H
        rows = max(1, BLOCK_BYTES // (2 * nk * self.nip * 16))
        eye = torch.eye(self.nip, dtype=C128, device=dev)
        out = []
        for q in range(nk):
            partner = torch.as_tensor(kq[:, q], device=dev)
            c = (gram.conj() * gram[partner]).sum(0)       # normal matrix
            d = torch.diagonal(c).real ** -0.5
            chol = torch.linalg.cholesky(d[:, None] * c * d[None, :]
                                         + ridge * eye)
            z = torch.empty((ng, self.nip), dtype=C128, device=dev)
            for i0 in range(0, ng, rows):
                a = phi[:, i0:i0 + rows] @ x.conj().transpose(1, 2)
                z[i0:i0 + rows] = (a.conj() * a[partner]).sum(0)
                del a
            z *= d[None, :]
            z = torch.linalg.solve_triangular(chol.mH, z, upper=True,
                                              left=False)
            z = torch.linalg.solve_triangular(chol, z, upper=False,
                                              left=False)
            z *= d[None, :]                                 # zeta (ng, nip)
            qv = torch.as_tensor(sy.kpts[q], dtype=F64, device=dev)
            z *= torch.exp(-1j * (r @ qv))[:, None]
            gq2 = ((gv + qv) ** 2).sum(1)
            v = torch.where(gq2 > 1e-12, 4.0 * math.pi / gq2.clamp_min(1e-12),
                            0.0)
            scale = torch.sqrt(v * sy.vol) / ng
            for c0 in range(0, self.nip, 128):
                blk = z[:, c0:c0 + 128].T.contiguous()
                z[:, c0:c0 + 128] = (sy.fft(blk) * scale).T
            out.append(z.T @ z.conj())
            del z
        # the exact metric keeps time reversal, M^-q = conj(M^q), for real
        # basis functions; the mesh's G+q, one-sided at the cutoff, breaks
        # it by a little: take the symmetric part
        m = torch.stack(out)
        minus = torch.as_tensor(k_index(sy.kfrac, -sy.kfrac), device=dev)
        return 0.5 * (m + m[minus].conj())

    def get_jk(self, dm):
        """(J (nk, nao, nao) of the total density, K (2, nk, nao, nao))."""
        x, nk = self.x, self.nk
        rk = x @ dm @ x.mH                                  # (2, nk, nip, nip)
        rho = torch.diagonal(rk, dim1=-2, dim2=-1).sum((0, 1)) / nk
        v = self.metric[0] @ rho
        vj = x.mH @ (v[None, :, None] * x)
        vk = torch.empty_like(dm)
        for k in range(nk):
            m = self.metric[torch.as_tensor(self.qk[k], device=x.device)]
            w = (m[None] * rk).sum(1) / nk                  # (2, nip, nip)
            vk[:, k] = x[k].mH @ w @ x[k]
        return vj, vk

    def fock_energy(self, dm):
        """(fock (2, nk, nao, nao), total energy) at the spin density."""
        vj, vk = self.get_jk(dm)
        h = self.h1e
        fock = h + vj - vk
        dmt = dm.transpose(-1, -2)
        e = ((dmt * h).sum() + 0.5 * (dmt * vj).sum()
             - 0.5 * (dmt * vk).sum()).real / self.nk
        return fock, float(e) + self.e_nuc

    def time_reversed(self, m):
        """The time-reversal symmetric part (M_k + conj(M_-k)) / 2 of
        matrices over the k-points (the axis before the last two).  The
        exact core Hamiltonian keeps time reversal, as the metric does;
        the mesh's G+k, one-sided at the cutoff, breaks it by a little, and
        so does the density of an SCF built on it: the reference's UHF
        keeps it."""
        return 0.5 * (m + m.index_select(-3, self.minus_k).conj())

    def density(self, fock):
        """The Fermi-smeared spin density of ``fock``, each spin's count
        fixed."""
        fo = self.orth.mH @ fock @ self.orth
        fo = fo + torch.diag_embed(torch.where(self.keep, 0.0, 1e6)
                                   ).to(C128)
        e, c = torch.linalg.eigh(fo)
        occ = torch.stack([self._fermi(e[s], self.nocc[s] * self.nk)
                           for s in (0, 1)])
        mo = self.orth @ c
        return self.time_reversed((mo * occ[:, :, None, :].to(C128))
                                  @ mo.mH)

    def _fermi(self, e, n):
        lo, hi = float(e.min()) - 1.0, float(e[e < 1e5].max()) + 1.0
        for _ in range(200):
            mu = 0.5 * (lo + hi)
            if float(torch.sigmoid((mu - e) / self.sigma).sum()) > n:
                hi = mu
            else:
                lo = mu
        return torch.sigmoid((0.5 * (lo + hi) - e) / self.sigma)

    def converge(self, dm0):
        """(energy, density, cycles, last |dE|, last |ddm|) of the fixed
        point reached from ``dm0`` by Pulay DIIS."""
        dm = self.time_reversed(as_tensor(dm0, self.device))
        s = self.s1e
        focks, errs = [], []
        e_last, de, ddm, it = None, float("inf"), float("inf"), 0
        for it in range(1, MAX_CYCLE + 1):
            fock, e = self.fock_energy(dm)
            focks.append(fock)
            errs.append(fock @ dm @ s - s @ dm @ fock)
            del focks[:-DIIS_SPACE], errs[:-DIIS_SPACE]
            n = len(errs)
            b = torch.zeros((n + 1, n + 1), dtype=F64, device=self.device)
            for i in range(n):
                for j in range(n):
                    b[i, j] = torch.vdot(errs[i].reshape(-1),
                                         errs[j].reshape(-1)).real
            b[n, :n] = b[:n, n] = -1.0
            rhs = torch.zeros(n + 1, dtype=F64, device=self.device)
            rhs[n] = -1.0
            coef = torch.linalg.lstsq(b, rhs[:, None]).solution[:n, 0]
            fock = sum(ci * fi for ci, fi in zip(coef.to(C128), focks))
            dm_new = self.density(fock)
            ddm = float((dm_new - dm).abs().max())
            de = abs(e - e_last) if e_last is not None else float("inf")
            dm, e_last = dm_new, e
            if de < E_TOL and ddm < DM_TOL:
                break
        _, e = self.fock_energy(dm)
        return e, dm, it, de, ddm

    def moments(self, dm):
        """Mulliken spin moment of each atom of the spin density."""
        dm = as_tensor(dm, self.device)
        pop = torch.diagonal((dm[0] - dm[1]) @ self.s1e, dim1=-2,
                             dim2=-1).real.sum(0) / self.nk
        return np.array([float(pop[a:b].sum()) for a, b in self.sys.atom_ao])

    def judge(self, e_prog, dm_prog):
        """The numbers of one answer, and the reference's own readings."""
        t0 = time.perf_counter()
        e_ref, dm_ref, cycles, de, ddm = self.converge(dm_prog)
        self.seconds["converge"] = time.perf_counter() - t0
        natm = len(self.sys.atoms)
        m_prog, m_ref = self.moments(dm_prog), self.moments(dm_ref)
        return {"energy_gap": abs(float(e_prog) - e_ref) / natm,
                "moment_gap": float(np.abs(m_prog - m_ref).max()),
                "e_ref": e_ref, "ref_cycles": cycles, "ref_de": de,
                "ref_ddm": ddm, "moments_ref": m_ref.tolist(),
                "moments_program": m_prog.tolist()}
