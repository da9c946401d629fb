"""Atom-centred (Becke) integration grids for periodic cells.

The port's copy of the JAX package's ``fftisdf_tpu/lattice/becke.py``
(numpy only, host side).  The reference's LS-THC pulls ``BeckeGrids`` from
an external ``thc`` package (its ``k_least_square.py:14,
89-90``); this is the native equivalent:

- radial: Gauss-Chebyshev (2nd kind) points mapped through Becke's
  r = rm (1+x)/(1-x) transformation, atom-size adjusted;
- angular: Gauss-Legendre (theta) x uniform (phi) product shells, exact for
  spherical harmonics up to degree 2*ntheta-1;
- weights: Becke's smooth Voronoi partition (3 iterations of the cubic
  switching polynomial) over the atoms of the home cell and their relevant
  lattice images, so each point's weight sums the periodic partition.

The quadrature integrates smooth atom-centred densities over the cell:
sum_g w_g f(r_g) ~= integral_cell f for lattice-periodic f built from
decaying atomic contributions.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.basis.data import element_symbol

# Bragg-Slater radii (Angstrom) for size-adapted radial maps
_BRAGG_A = {
    "H": 0.35, "He": 0.93, "Li": 1.45, "Be": 1.05, "B": 0.85, "C": 0.70,
    "N": 0.65, "O": 0.60, "F": 0.50, "Ne": 0.71, "Na": 1.80, "Mg": 1.50,
    "Al": 1.25, "Si": 1.10, "P": 1.00, "S": 1.00, "Cl": 1.00, "Ar": 0.98,
    "K": 2.20, "Ca": 1.80, "Sc": 1.60, "Ti": 1.40, "V": 1.35, "Cr": 1.40,
    "Mn": 1.40, "Fe": 1.40, "Co": 1.35, "Ni": 1.35, "Cu": 1.35, "Zn": 1.35,
}
_BOHR = 0.52917721092
# centres per block of the partition's cell functions
_BLOCK = 16


def radial_becke(n, rm):
    """Gauss-Chebyshev-2 nodes mapped to (0, inf) via r = rm (1+x)/(1-x).

    Returns (r, w) with w including the r^2 jacobian (so
    sum w_i f(r_i) ~= int_0^inf r^2 f(r) dr)."""
    i = np.arange(1, n + 1)
    x = np.cos(i * np.pi / (n + 1))
    wch = np.pi / (n + 1) * np.sin(i * np.pi / (n + 1)) ** 2
    r = rm * (1 + x) / (1 - x)
    # dr/dx = 2 rm / (1-x)^2 ; chebyshev weight carries 1/sqrt(1-x^2)
    drdx = 2.0 * rm / (1 - x) ** 2
    w = wch / np.sqrt(1 - x ** 2) * drdx * r ** 2
    return r, w


def angular_product(ntheta):
    """Product angular grid: (npts, 3) unit vectors and weights summing 4 pi."""
    xt, wt = np.polynomial.legendre.leggauss(ntheta)
    nphi = 2 * ntheta
    phi = 2 * np.pi * np.arange(nphi) / nphi
    wphi = 2 * np.pi / nphi
    ct = xt  # cos(theta)
    st = np.sqrt(1 - ct ** 2)
    pts = np.stack([
        np.outer(st, np.cos(phi)),
        np.outer(st, np.sin(phi)),
        np.outer(ct, np.ones(nphi)),
    ], axis=-1).reshape(-1, 3)
    w = np.outer(wt, np.full(nphi, wphi)).reshape(-1)
    return pts, w


def _becke_s(mu, k=3):
    """Becke's iterated switching function mapping mu in [-1,1] -> [0,1]."""
    p = mu
    for _ in range(k):
        # 1.5 p - 0.5 p^3, without numpy's slow float power
        p = p * (1.5 - 0.5 * p * p)
    return 0.5 * (1 - p)


class AtomCenteredGrids:
    """Becke-partitioned atom-centered grids for a periodic cell."""

    def __init__(self, cell, level=1):
        self.cell = cell
        self.level = level
        self.coords = None
        self.weights = None

    def build(self):
        cell = self.cell
        nrad = {0: 20, 1: 35, 2: 50, 3: 75}.get(self.level, 35)
        nth = {0: 6, 1: 10, 2: 14, 3: 20}.get(self.level, 10)
        ang_pts, ang_w = angular_product(nth)

        # periodic images of every atom that can matter for the partition
        a = np.asarray(cell.a)
        rcut = 8.0   # bohr: radial extent kept per atom; the partition
                     # product only needs centers within ~2*rcut
        vol = abs(np.linalg.det(a))
        heights = np.array([
            vol / np.linalg.norm(np.cross(a[(i + 1) % 3], a[(i + 2) % 3]))
            for i in range(3)
        ])
        nmax = np.ceil(rcut / heights).astype(int) + 1
        rng = [np.arange(-n, n + 1) for n in nmax]
        ints = np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
        ts = ints.astype(float) @ a

        centers = []
        radii = []
        for sym, xyz in cell.atom:
            rb = _BRAGG_A.get(element_symbol(sym), 1.0) / _BOHR
            for t in ts:
                centers.append(np.asarray(xyz) + t)
                radii.append(rb)
        centers = np.asarray(centers)
        radii = np.asarray(radii)

        all_coords, all_w = [], []
        home = [i for i, t in enumerate(ts)
                if np.all(np.abs(t) < 1e-12)]
        assert len(home) == 1
        home_off = home[0]  # centers index of atom ia in home cell:
        # centers are laid out atom-major: ia * len(ts) + image
        nimg = len(ts)

        for ia, (sym, xyz) in enumerate(cell.atom):
            rm = _BRAGG_A.get(element_symbol(sym), 1.0) / _BOHR
            r, wr = radial_becke(nrad, rm)
            keep = r < rcut
            r, wr = r[keep], wr[keep]
            pts = (r[:, None, None] * ang_pts[None, :, :]).reshape(-1, 3)
            w0 = (wr[:, None] * ang_w[None, :]).reshape(-1)
            pts = pts + np.asarray(xyz)[None, :]
            # prune: only centers that can influence this atom's points
            sel = np.linalg.norm(centers - np.asarray(xyz)[None, :],
                                 axis=1) <= 2.0 * rcut + 1.0
            idx_home_global = ia * nimg + home_off
            sel[idx_home_global] = True
            csel = np.where(sel)[0]
            cen = centers[csel]
            rad = radii[csel]
            idx_home = int(np.where(csel == idx_home_global)[0][0])
            d = np.linalg.norm(pts[:, None, :] - cen[None, :, :], axis=-1)
            nc = len(cen)
            # pairwise data
            rbc = np.linalg.norm(cen[:, None, :] - cen[None, :, :], axis=-1)
            chi = rad[:, None] / rad[None, :]
            u = (chi - 1) / (chi + 1)
            aij = np.clip(u / (u ** 2 - 1), -0.5, 0.5)
            # cell functions p[:, b] = prod_{c != b} s(mu_bc), a block of
            # centres b at a time (the partners c = b contribute 1)
            p = np.ones((len(pts), nc))
            for b0 in range(0, nc, _BLOCK):
                bs = slice(b0, b0 + _BLOCK)
                off = rbc[bs] > 1e-10
                mu = ((d[:, bs, None] - d[:, None, :])
                      / np.where(off, rbc[bs], 1.0)[None])
                mu = mu + aij[bs][None] * (1 - mu ** 2)
                sw = np.where(off[None], _becke_s(np.clip(mu, -1, 1)), 1.0)
                p[:, bs] = np.prod(sw, axis=2)
            wbecke = p[:, idx_home] / np.maximum(p.sum(axis=1), 1e-300)
            all_coords.append(pts)
            all_w.append(w0 * wbecke)

        self.coords = np.concatenate(all_coords, axis=0)
        self.weights = np.concatenate(all_w, axis=0)
        return self
