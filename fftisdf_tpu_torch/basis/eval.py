"""Periodic GTO evaluation on real-space grids (PyTorch).

Counterpart of ``fftisdf_tpu/basis/eval.py``.  The Bloch AO at k is a
lattice sum over translation images::

    phi_{k,mu}(r) = sum_T  exp(i k.T) * chi_mu(r - A_mu - T)

Shells are grouped by center; each group shares one image list and one
(ng, nT) distance tensor, and the image sum with k-phases is a pair of real
matmuls.  Coordinates are wrapped into the home cell with the compensating
Bloch phase, so the finite image lists stay exact everywhere.

The evaluator works through the grid in blocks so that the largest
temporary, a group's (blk, nT, nfunc) chi tensor, stays near a fixed byte
budget whatever the grid size.

``dtype`` (``torch.float64`` by default, or ``torch.float32``) is the
precision the evaluator works in, coordinates included, as in the JAX
package: the float32 regime evaluates its AOs in float32, and selection in
float64 inside a float32 build uses a float64 evaluator.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch import native
from fftisdf_tpu_torch.basis.gto import (normalized_coeffs,
                                         real_solid_harmonics, shell_rcut)

# the constant S_00 of real_solid_harmonics
_S00 = float(real_solid_harmonics(np.ones(()), None, None, 0, np)[0])
from fftisdf_tpu_torch.utils.device import real_complex, resolve_device

# per-block budget of the chi / distance temporaries
_CHI_BLOCK_BYTES = 256 * 2**20
# A grid point on a face of the home cell has an integer fractional
# coordinate in exact arithmetic; computed, it lands a few ulps to either
# side, and the side depends on the device's summation order.  The two wraps
# differ by the image lists' truncation (1.5e-12 on diamond gth-szv ke 50),
# so two devices could disagree there: coordinates within WRAP_EPS below
# an integer wrap as that integer on every device.
WRAP_EPS = 1e-9


def home_translation(coords, ainv, a):
    """Lattice translation T with ``coords - T`` in the home cell (up to
    WRAP_EPS): ``floor(coords @ ainv + WRAP_EPS) @ a``."""
    return torch.floor(coords @ ainv + WRAP_EPS) @ a


def _cell_geometry(cell):
    a = np.asarray(cell.a)
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], dtype=np.float64) @ a
    center = corners.mean(axis=0)
    radius = np.linalg.norm(corners - center, axis=1).max()
    return center, radius


def shell_images(cell, center: np.ndarray, rcut: float) -> np.ndarray:
    """Lattice translations T with ||center + T - cell_center|| <= rcut +
    r_cell: a superset of the images whose shifted Gaussian reaches the
    unit cell above the precision."""
    a = np.asarray(cell.a)
    ccenter, cradius = _cell_geometry(cell)
    reach = rcut + cradius
    vol = abs(np.linalg.det(a))
    heights = np.array([
        vol / np.linalg.norm(np.cross(a[(i + 1) % 3], a[(i + 2) % 3]))
        for i in range(3)])
    nmax = np.ceil((reach + np.linalg.norm(center - ccenter))
                   / heights).astype(int) + 1
    ts_native = native.enumerate_images(a, center, ccenter, reach, nmax)
    if ts_native is not None:
        return ts_native
    rng = [np.arange(-n, n + 1) for n in nmax]
    ints = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, 3)
    ts = ints.astype(np.float64) @ a
    keep = np.linalg.norm(center + ts - ccenter, axis=1) <= reach
    return ts[keep]


class ShellSpec:
    """Host-side static data for one contracted shell."""

    def __init__(self, cell, center, shell, precision):
        self.l = shell.l
        self.rpow = getattr(shell, "rpow", 0)
        self.center = np.asarray(center)
        self.exps = np.asarray(shell.exps)
        if getattr(shell, "raw", False):
            self.coeffs = np.asarray(shell.coeffs, dtype=np.float64)
        else:
            self.coeffs = normalized_coeffs(shell.l, shell.exps, shell.coeffs)
        self.nctr = self.coeffs.shape[1]
        self.nfunc = (2 * shell.l + 1) * self.nctr
        self.rcut = shell_rcut(shell.l + 2 * self.rpow, self.exps,
                               shell.coeffs, precision)


def build_shell_table(cell, precision=None, shells=None):
    """Shell table from the cell's basis, or from an explicit list of
    (center, Shell) pairs (the GTH projectors of scf.integrals)."""
    precision = cell.precision if precision is None else precision
    if shells is None:
        shells = [(xyz, sh) for _, _, xyz, sh in cell.shells()]
    return [ShellSpec(cell, xyz, sh, precision) for xyz, sh in shells]


class CenterGroup:
    """Shells sharing a center: one image list, one distance tensor."""

    def __init__(self, cell, center, specs):
        self.center = np.asarray(center)
        self.specs = specs
        self.images = shell_images(cell, self.center,
                                   max(s.rcut for s in specs))
        self.nfunc = sum(s.nfunc for s in specs)


def _group_by_center(cell, table):
    """Center groups in first-appearance order (keeps the AO order)."""
    groups = {}
    order = []
    for spec in table:
        key = tuple(np.round(spec.center, 12))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(spec)
    return [CenterGroup(cell, groups[key][0].center, groups[key])
            for key in order]


def _group_chi(coords, group_specs, group_exps, centers):
    """chi values of all shells of a center group: (ng, nT, nfunc) real.

    ``group_exps`` holds the group's distinct exponent sets and
    ``group_specs`` (l, rpow, nfunc, exps index, coeffs), the arrays as
    tensors on the coordinates' device: the shells of one basis set share
    their exponents, so each set's Gaussians are evaluated once."""
    dx, dy, dz = (coords[:, None, i] - centers[None, :, i]
                  for i in range(3))                      # (g, T) each
    r2 = dx * dx + dy * dy + dz * dz
    gauss = [torch.mul(r2[..., None], -exps).exp_() for exps in group_exps]
    nfunc_all = sum(spec[2] for spec in group_specs)
    out = torch.empty(r2.shape + (nfunc_all,), dtype=r2.dtype,
                      device=r2.device)
    f0 = 0
    for l, rpow, nfunc, iexp, coeffs in group_specs:
        rad = gauss[iexp] @ coeffs                        # (g, T, nctr)
        for _ in range(rpow):
            rad = rad * r2[..., None]
        chi = out[..., f0:f0 + nfunc].view(r2.shape + (2 * l + 1, -1))
        if l == 0:                      # S_00 is a constant
            torch.mul(rad, _S00, out=chi[..., 0, :])
        else:
            for m, ang in enumerate(real_solid_harmonics(dx, dy, dz, l,
                                                         torch)):
                torch.mul(rad, ang[..., None], out=chi[..., m, :])
        f0 += nfunc
    return out


def group_specs(group, t):
    """(specs, exps) of a center group for :func:`_group_chi`: the shells
    as (l, rpow, nfunc, exps index, coeffs) and the group's distinct
    exponent sets, arrays converted by ``t`` (to device tensors)."""
    exps, specs = [], []
    for s in group.specs:
        iexp = next((i for i, e in enumerate(exps)
                     if np.array_equal(e, s.exps)), len(exps))
        if iexp == len(exps):
            exps.append(s.exps)
        specs.append((s.l, s.rpow, s.nfunc, iexp, t(s.coeffs)))
    return specs, [t(e) for e in exps]


class Evaluator:
    """``fn(coords) -> (nk, ng, nao)`` complex Bloch AOs (``(ng, nao)`` real
    at the gamma point, ``kpts=None``), on ``device``.

    Built by :func:`make_evaluator`; holds the shell groups, their image
    lists and the k-phases as device tensors."""

    def __init__(self, cell, kpts, precision, shells, device, dtype=None):
        self.device = device
        self.rdtype, self.cdtype = real_complex(dtype)
        precision = cell.precision if precision is None else precision
        table = build_shell_table(cell, precision, shells)
        groups = _group_by_center(cell, table)
        self.gamma = kpts is None
        self.nao = sum(g.nfunc for g in groups)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.rdtype,
                                      device=device)
        self.ainv = t(np.linalg.inv(np.asarray(cell.a)))
        self.a = t(cell.a)
        self.kpts = None if self.gamma else t(kpts)
        self.groups = []
        self.max_chi_row = 1
        for g in groups:
            specs, exps = group_specs(g, t)
            centers = t(g.center[None, :] + g.images)
            if self.gamma:
                ph = None
            else:
                ang = np.asarray(g.images) @ np.asarray(kpts).T   # (T, nk)
                ph = (t(np.cos(ang)), t(np.sin(ang)))
            self.groups.append((specs, exps, centers, ph))
            nprim = max(len(s.exps) for s in g.specs)
            self.max_chi_row = max(
                self.max_chi_row, len(g.images) * (g.nfunc + nprim + 8))

    def block_size(self, ng):
        """Grid points per block for the chi byte budget."""
        return int(max(64, min(ng, _CHI_BLOCK_BYTES
                               // (self.rdtype.itemsize
                                   * self.max_chi_row))))

    def _block(self, coords):
        # wrap into the home cell: r = r0 + T, phi_k(r) = e^{ik.T} phi_k(r0)
        tvec = home_translation(coords, self.ainv, self.a)
        coords0 = coords - tvec
        blocks = []
        for specs, exps, centers, ph in self.groups:
            chi = _group_chi(coords0, specs, exps, centers)   # (g, T, f)
            if self.gamma:
                blocks.append(chi.sum(dim=1))
                continue
            chi_t = chi.transpose(1, 2)                   # (g, f, T)
            out_r = (chi_t @ ph[0]).permute(2, 0, 1)      # (k, g, f)
            out_i = (chi_t @ ph[1]).permute(2, 0, 1)
            blocks.append(torch.complex(out_r, out_i))
        out = torch.cat(blocks, dim=-1)
        if not self.gamma:
            ang = tvec @ self.kpts.T                      # (g, k)
            pt = torch.polar(torch.ones_like(ang), ang)
            out = out * pt.T[:, :, None]
        return out

    def __call__(self, coords):
        coords = torch.as_tensor(coords, dtype=self.rdtype,
                                 device=self.device)
        ng = coords.shape[0]
        blk = self.block_size(ng)
        if blk >= ng:
            return self._block(coords)
        shape = ((ng, self.nao) if self.gamma
                 else (len(self.kpts), ng, self.nao))
        out = torch.empty(
            shape, dtype=self.rdtype if self.gamma else self.cdtype,
            device=self.device)
        for g0 in range(0, ng, blk):
            g1 = min(g0 + blk, ng)
            if self.gamma:
                out[g0:g1] = self._block(coords[g0:g1])
            else:
                out[:, g0:g1] = self._block(coords[g0:g1])
        return out


def make_evaluator(cell, kpts=None, precision=None, dtype=None, shells=None,
                   *, device="cuda"):
    """Bloch AO evaluator ``fn(coords) -> (nk, ng, nao)`` on ``device``,
    working in ``dtype`` (float64 when None).

    ``kpts=None`` gives the gamma-point real evaluator (``(ng, nao)``);
    ``shells`` overrides the cell basis with explicit (center, Shell)
    pairs."""
    return Evaluator(cell, None if kpts is None else np.asarray(kpts),
                     precision, shells, resolve_device(device), dtype)


def eval_ao_kpts(cell, coords, kpts, precision=None, dtype=None, *,
                 device="cuda"):
    """One-shot evaluation: (nk, ng, nao) complex Bloch AOs."""
    return make_evaluator(cell, kpts=kpts, precision=precision, dtype=dtype,
                          device=device)(coords)


def eval_ao_gamma(cell, coords, precision=None, dtype=None, *,
                  device="cuda"):
    """Gamma-point (real) AO values: (ng, nao)."""
    return make_evaluator(cell, kpts=None, precision=precision, dtype=dtype,
                          device=device)(coords)
