"""The plain reference's periodic system, written from the definitions.

- the cell, its FFT mesh (plane waves with |G|^2/2 <= ke_cutoff along
  each axis, rounded up to a 2,3,5,7-smooth size) and its k-points
  (i/n along each reciprocal vector, C order);
- contracted real solid-harmonic Gaussians, each contraction normalised
  to one, in the configuration's AO order (atoms, then shells as the
  tables list them, then m = -l..l, then the shell's contractions),
  summed over lattice images into Bloch functions
  phi_k(r) = sum_T e^{ik.T} chi(r - A - T);
- the one-electron matrices by quadrature on the mesh: overlap, kinetic
  through the FFT, the GTH local part from its form factor, the GTH
  projectors Bloch-summed on the mesh;
- the Ewald energy of the ions with a neutralising background.

Tables come from ``tables.json`` beside this file.  Plain torch and
numpy; nothing of the program is imported."""
from __future__ import annotations

import itertools
import json
import math
from pathlib import Path

import numpy as np
import torch

TABLES = json.loads((Path(__file__).parent / "tables.json").read_text())
F64, C128 = torch.float64, torch.complex128
IMAGE_TOL = 1e-13          # a Gaussian below this at the home cell is dropped
AO_BLOCK_BYTES = 512 * 2**20


def smooth_size(n):
    """The smallest 2,3,5,7-smooth integer >= n."""
    while True:
        m = n
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def solid_harmonics(d, l):
    """Real solid harmonics r^l Y_lm(d), m = -l..l: (..., 2l+1)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    if l == 0:
        return torch.full_like(x, 0.5 / math.sqrt(math.pi))[..., None]
    if l == 1:
        c = math.sqrt(3.0 / (4.0 * math.pi))
        return torch.stack([c * y, c * z, c * x], -1)
    if l == 2:
        c1 = math.sqrt(15.0 / (4.0 * math.pi))
        c0 = math.sqrt(5.0 / (16.0 * math.pi))
        c2 = math.sqrt(15.0 / (16.0 * math.pi))
        return torch.stack([c1 * x * y, c1 * y * z,
                            c0 * (2.0 * z * z - x * x - y * y),
                            c1 * x * z, c2 * (x * x - y * y)], -1)
    raise NotImplementedError(f"l = {l}")


def radial_norm(n, a):
    """1 / sqrt(int_0^inf r^2 (r^n e^{-a r^2})^2 dr)."""
    return 1.0 / math.sqrt(math.gamma(n + 1.5) / (2.0 * (2.0 * a) ** (n + 1.5)))


class Function:
    """One radial shell at a centre: sum_p c[p, j] r^(2 rpow) e^{-a_p r^2}
    times the 2l+1 solid harmonics, for each column j."""

    def __init__(self, center, l, exps, coeffs, rpow=0):
        self.center = np.asarray(center, dtype=float)
        self.l, self.rpow = int(l), int(rpow)
        self.exps = np.asarray(exps, dtype=float)
        self.coeffs = np.asarray(coeffs, dtype=float).reshape(len(exps), -1)
        self.nfunc = (2 * self.l + 1) * self.coeffs.shape[1]
        amin = self.exps.min()
        cmax = max(1.0, float(np.abs(self.coeffs).max()))
        r = 1.0
        for _ in range(4):
            r = math.sqrt(math.log(cmax * max(r, 1.0) ** (self.l + 2 * self.rpow)
                                   / IMAGE_TOL) / amin)
        self.rcut = r


def contracted(center, l, rows):
    """A basis shell from its table rows [exponent, c_1, c_2, ...]: the
    primitive norms folded in, each column normalised to one."""
    rows = np.asarray(rows, dtype=float)
    a, c = rows[:, 0], rows[:, 1:].copy()
    c *= np.array([radial_norm(l, x) for x in a])[:, None]
    ee = a[:, None] + a[None, :]
    s = math.gamma(l + 1.5) / (2.0 * ee ** (l + 1.5))
    c /= np.sqrt(np.einsum("pi,qi,pq->i", c, c, s))[None, :]
    return Function(center, l, a, c)


def discard(rows, exp_min):
    """Table rows without the primitives below ``exp_min``; columns left
    all zero go; None where nothing is left."""
    rows = np.asarray(rows, dtype=float)
    rows = rows[rows[:, 0] >= exp_min]
    if not len(rows):
        return None
    keep = np.abs(rows[:, 1:]).max(axis=0) > 0
    if not keep.any():
        return None
    return np.concatenate([rows[:, :1], rows[:, 1:][:, keep]], axis=1)


class System:
    """A cell of the configuration at one geometry (bohr)."""

    def __init__(self, cfg, lattice, atoms, device):
        self.device = device
        self.a = np.asarray(lattice, dtype=float)
        self.atoms = [(s, np.asarray(x, dtype=float)) for s, x in atoms]
        self.vol = abs(float(np.linalg.det(self.a)))
        self.b = 2.0 * np.pi * np.linalg.inv(self.a).T
        gmax = math.sqrt(2.0 * float(cfg["ke_cutoff"]))
        self.mesh = tuple(smooth_size(2 * int(math.ceil(
            gmax * np.linalg.norm(ai) / (2.0 * np.pi))) + 1) for ai in self.a)
        self.ngrid = int(np.prod(self.mesh))
        km = [int(n) for n in cfg["kmesh"]]
        self.kmesh = km
        self.kfrac = np.array(list(itertools.product(*[np.arange(n) / n
                                                       for n in km])))
        self.kpts = self.kfrac @ self.b
        self.nk = len(self.kpts)
        basis = TABLES["basis"][cfg["basis"]]
        self.pseudo = {s: TABLES["pseudo"][cfg["pseudo"]][s]
                       for s in {s for s, _ in self.atoms}}
        self.shells, self.atom_ao = [], []
        for s, xyz in self.atoms:
            n0 = sum(f.nfunc for f in self.shells)
            for l, rows in basis[s]:
                if cfg.get("exp_to_discard") is not None:
                    rows = discard(rows, float(cfg["exp_to_discard"]))
                if rows is not None:
                    self.shells.append(contracted(xyz, l, rows))
            self.atom_ao.append((n0, sum(f.nfunc for f in self.shells)))
        self.nao = sum(f.nfunc for f in self.shells)
        self.charges = np.array([self.pseudo[s]["zion"] for s, _ in self.atoms])
        self.nelectron = int(round(self.charges.sum()))

    # -- grids --------------------------------------------------------
    def grid(self, mesh=None):
        """Uniform points of ``mesh`` (default: the FFT mesh): (n, 3)."""
        mesh = self.mesh if mesh is None else mesh
        frac = np.array(list(itertools.product(*[np.arange(n) / n
                                                 for n in mesh])))
        return frac @ self.a

    def gvectors(self):
        """Reciprocal vectors of the FFT bins in fftn order: (ngrid, 3)."""
        f = [np.fft.fftfreq(n, 1.0 / n) for n in self.mesh]
        return np.array(list(itertools.product(*f))) @ self.b

    def fft(self, x):
        """FFT over the mesh of the last axis of ``x`` (..., ngrid)."""
        lead = x.shape[:-1]
        y = torch.fft.fftn(x.reshape(*lead, *self.mesh), dim=(-3, -2, -1))
        return y.reshape(*lead, self.ngrid)

    def ifft(self, x):
        lead = x.shape[:-1]
        y = torch.fft.ifftn(x.reshape(*lead, *self.mesh), dim=(-3, -2, -1))
        return y.reshape(*lead, self.ngrid)

    # -- Bloch functions ---------------------------------------------
    def _images(self, center, rcut):
        """Translations T whose image of a function at ``center`` reaches
        the home cell within ``rcut``."""
        corners = np.array(list(itertools.product((0, 1), repeat=3))) @ self.a
        mid = corners.mean(0)
        reach = rcut + np.linalg.norm(corners - mid, axis=1).max()
        heights = self.vol / np.array([np.linalg.norm(np.cross(
            self.a[(i + 1) % 3], self.a[(i + 2) % 3])) for i in range(3)])
        n = np.ceil((reach + np.linalg.norm(center - mid)) / heights
                    ).astype(int) + 1
        ints = np.array(list(itertools.product(*[range(-m, m + 1)
                                                 for m in n])), dtype=float)
        ts = ints @ self.a
        return ts[np.linalg.norm(center + ts - mid, axis=1) <= reach]

    def bloch(self, coords, kpts=None, functions=None):
        """phi_k at ``coords`` (n, 3): (nk, n, nfunc) complex128 on the
        device, for the basis or for ``functions``."""
        funcs = self.shells if functions is None else functions
        kpts = self.kpts if kpts is None else np.asarray(kpts)
        dev = self.device
        r = torch.as_tensor(np.asarray(coords), dtype=F64, device=dev)
        nfunc = sum(f.nfunc for f in funcs)
        out = torch.zeros((len(kpts), len(r), nfunc), dtype=C128, device=dev)
        k_t = torch.as_tensor(kpts, dtype=F64, device=dev)
        col = 0
        for f in funcs:
            ts = torch.as_tensor(self._images(f.center, f.rcut), dtype=F64,
                                 device=dev)
            ph = torch.exp(1j * (ts @ k_t.T))                 # (nT, nk)
            a = torch.as_tensor(f.exps, dtype=F64, device=dev)
            c = torch.as_tensor(f.coeffs, dtype=F64, device=dev)
            cen = torch.as_tensor(f.center, dtype=F64, device=dev)
            nm = 2 * f.l + 1
            blk = max(1, AO_BLOCK_BYTES // (len(ts) * (len(a) + nm * c.shape[1])
                                            * 16))
            for i0 in range(0, len(r), blk):
                d = r[i0:i0 + blk, None, :] - cen - ts[None]    # (b, nT, 3)
                r2 = (d * d).sum(-1)
                rad = torch.exp(-r2[..., None] * a) @ c         # (b, nT, nc)
                if f.rpow:
                    rad = rad * (r2 ** f.rpow)[..., None]
                ang = solid_harmonics(d, f.l)                   # (b, nT, nm)
                chi = (ang[..., :, None] * rad[..., None, :]).reshape(
                    *r2.shape, -1)                 # (b, nT, nf), m-major
                out[:, i0:i0 + blk, col:col + f.nfunc] = torch.einsum(
                    "btf,tk->kbf", chi.to(C128), ph)
            col += f.nfunc
        return out

    # -- one-electron matrices ----------------------------------------
    def projectors(self):
        """GTH projector functions and their coupling matrix h."""
        funcs, blocks = [], []
        for s, xyz in self.atoms:
            for l, rl, h in self.pseudo[s]["projectors"]:
                h = np.asarray(h, dtype=float)
                for i in range(1, len(h) + 1):
                    nrm = math.sqrt(2.0) / (rl ** (l + (4 * i - 1) / 2.0)
                                            * math.sqrt(math.gamma(
                                                l + (4 * i - 1) / 2.0)))
                    funcs.append(Function(xyz, l, [0.5 / rl ** 2], [nrm],
                                          rpow=i - 1))
                blocks.append((h, 2 * l + 1))
        n = sum(len(h) * nm for h, nm in blocks)
        hmat, off = np.zeros((n, n)), 0
        for h, nm in blocks:
            ni = len(h)
            for i, j, m in itertools.product(range(ni), range(ni), range(nm)):
                hmat[off + i * nm + m, off + j * nm + m] = h[i, j]
            off += ni * nm
        return funcs, hmat

    def vloc_grid(self):
        """The local pseudopotential on the mesh: (ngrid,) real."""
        gv = self.gvectors()
        g2 = (gv * gv).sum(1)
        zero = g2 < 1e-12
        vg = np.zeros(self.ngrid, dtype=complex)
        for s, xyz in self.atoms:
            p = self.pseudo[s]
            z, rl = p["zion"], p["rloc"]
            c = np.zeros(4)
            c[:len(p["cloc"])] = p["cloc"]
            x2 = g2 * rl * rl
            poly = (c[0] + c[1] * (3.0 - x2) + c[2] * (15.0 - 10.0 * x2 + x2 ** 2)
                    + c[3] * (105.0 - 105.0 * x2 + 21.0 * x2 ** 2 - x2 ** 3))
            form = np.exp(-0.5 * x2) * (
                -4.0 * np.pi * z / np.where(zero, 1.0, g2)
                + math.sqrt(8.0 * np.pi ** 3) * rl ** 3 * poly)
            form[zero] = (2.0 * np.pi * z * rl * rl + math.sqrt(8.0 * np.pi ** 3)
                          * rl ** 3 * (c[0] + 3 * c[1] + 15 * c[2] + 105 * c[3]))
            vg += form * np.exp(-1j * gv @ xyz)
        v = torch.as_tensor(vg, dtype=C128, device=self.device)
        return self.ifft(v).real * (self.ngrid / self.vol)

    def one_electron(self, phi):
        """(S, H) (nk, nao, nao) from the Bloch functions on the mesh
        ``phi`` (nk, ngrid, nao): overlap and the core Hamiltonian
        (kinetic + local + nonlocal pseudopotential)."""
        coords = self.grid()
        w = self.vol / self.ngrid
        gv = torch.as_tensor(self.gvectors(), dtype=F64, device=self.device)
        r = torch.as_tensor(coords, dtype=F64, device=self.device)
        vloc = self.vloc_grid()
        pfun, hmat = self.projectors()
        h_t = torch.as_tensor(hmat, dtype=C128, device=self.device)
        proj = self.bloch(coords, functions=pfun)                # (nk, ng, np)
        s_all, h_all = [], []
        for k, kpt in enumerate(self.kpts):
            k_t = torch.as_tensor(kpt, dtype=F64, device=self.device)
            s_all.append(w * phi[k].mH @ phi[k])
            cg = self.fft((phi[k] * torch.exp(-1j * (r @ k_t))[:, None]).T
                          ) / self.ngrid                         # (nao, ng)
            half_g2 = 0.5 * ((gv + k_t) ** 2).sum(1)
            kin = self.vol * (cg.conj() * half_g2) @ cg.T
            loc = w * phi[k].mH @ (vloc[:, None] * phi[k])
            b = w * proj[k].mH @ phi[k]
            h_all.append(kin + loc + b.mH @ h_t @ b)
            del cg
        return torch.stack(s_all), torch.stack(h_all)

    def ewald(self):
        """Ion-ion energy of the point charges with a neutralising
        background (the Ewald sum, converged to 1e-14 in both halves)."""
        q, xyz = self.charges, np.array([x for _, x in self.atoms])
        eta = math.sqrt(np.pi) / self.vol ** (1.0 / 3.0)     # Gaussian width
        rmax = math.sqrt(-math.log(1e-16)) / eta
        gmax = 2.0 * eta * math.sqrt(-math.log(1e-16))
        hr = self.vol / np.array([np.linalg.norm(np.cross(
            self.a[(i + 1) % 3], self.a[(i + 2) % 3])) for i in range(3)])
        nr = np.ceil(rmax / hr).astype(int) + 1
        ts = np.array(list(itertools.product(*[range(-m, m + 1) for m in nr]))
                      ) @ self.a
        e_real = 0.0
        for i in range(len(q)):
            for j in range(len(q)):
                d = np.linalg.norm(xyz[i] - xyz[j] + ts, axis=1)
                d = d[d > 1e-10]
                e_real += 0.5 * q[i] * q[j] * np.sum(
                    np.vectorize(math.erfc)(eta * d) / d)
        hg = 2.0 * np.pi / np.linalg.norm(self.a, axis=1)
        ng = np.ceil(gmax / hg).astype(int) + 1
        gs = np.array(list(itertools.product(*[range(-m, m + 1) for m in ng])),
                      dtype=float) @ self.b
        g2 = (gs * gs).sum(1)
        gs, g2 = gs[g2 > 1e-12], g2[g2 > 1e-12]
        sf = np.exp(1j * gs @ xyz.T) @ q
        e_recip = (2.0 * np.pi / self.vol) * np.sum(
            np.exp(-g2 / (4.0 * eta * eta)) / g2 * np.abs(sf) ** 2)
        e_self = eta / math.sqrt(np.pi) * np.sum(q * q)
        e_bg = np.pi / (2.0 * eta * eta * self.vol) * np.sum(q) ** 2
        return float(e_real + e_recip - e_self - e_bg)
