"""Core-Hamiltonian integrals on the FFT grid (GPW style) and the Ewald
energy.

Counterpart of the main-path part of ``fftisdf_tpu/scf/integrals.py``:

- overlap    S_k = w X_k^H X_k
- kinetic    T_k = vol sum_G (|G+k|^2/2) conj(c_m) c_n, c = FFT[phi e^{-ikr}]/N
- local PSP  analytic GTH form factor times structure factors, inverse FFT
             to the grid, quadrature
- nonlocal   Bloch-summed GTH projectors on the grid, h-coupled
- Ewald      point charges and a neutralising background, real-space sum
             through ``fftisdf_tpu_torch.native``

- Madelung    the probe-charge constant of the exchange's q+G = 0 term
- S_k        streamed over grid blocks (:func:`get_ovlp_kpts`)

AO tensors are (nk, ngrid, nao) complex128 or complex64 on any device;
results stay on that device, in that precision.  The truncated local
pseudopotential, Ewald sum and Madelung constant (SCF-level truncation) are
not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fftisdf_tpu_torch import native
from fftisdf_tpu_torch.basis import data as basis_data
from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.lattice.cell import Shell
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.utils.device import (free_memory_bytes, real_complex,
                                            resolve_device)


# --------------------------------------------------------------- one-electron
def get_ovlp(cell, ao_kpts):
    w = cell.vol / ao_kpts.shape[1]
    return w * (ao_kpts.mH @ ao_kpts)


def get_kinetic(cell, ao_kpts, kpts, coords=None):
    mesh = tuple(int(m) for m in cell.mesh)
    dev = ao_kpts.device
    ng = ao_kpts.shape[1]
    if coords is None:
        coords = cell.gen_uniform_grids()
    rdt = real_complex(ao_kpts.dtype)[0]
    gv = torch.as_tensor(cell.get_Gv(), dtype=rdt, device=dev)
    kpts = torch.as_tensor(np.asarray(kpts), dtype=rdt, device=dev)
    coords = torch.as_tensor(coords, dtype=rdt, device=dev)
    vol = float(cell.vol)
    out = []
    for ao_k, kpt in zip(ao_kpts, kpts):
        t = coords @ kpt
        phase = torch.polar(torch.ones_like(t), -t)
        c = fft3((ao_k * phase[:, None]).T, mesh) / ng   # (nao, ng)
        gk = gv + kpt[None, :]
        g2 = 0.5 * (gk * gk).sum(dim=1)
        out.append(vol * ((c.conj() * g2[None, :]) @ c.T))
    return torch.stack(out)


# ----------------------------------------------------------------- local PSP
def gth_vloc_G(pseudo, G2):
    """GTH local form factor vloc(|G|) for G2 > 0 (without 1/vol)."""
    rloc, zion = pseudo.rloc, pseudo.zion
    c = np.zeros(4)
    c[: len(pseudo.cloc)] = pseudo.cloc
    x2 = G2 * rloc ** 2
    damp = np.exp(-0.5 * x2)
    poly = (c[0]
            + c[1] * (3.0 - x2)
            + c[2] * (15.0 - 10.0 * x2 + x2 ** 2)
            + c[3] * (105.0 - 105.0 * x2 + 21.0 * x2 ** 2 - x2 ** 3))
    return damp * (-4.0 * np.pi * zion / np.where(G2 > 0, G2, 1.0)
                   + math.sqrt(8.0 * np.pi ** 3) * rloc ** 3 * poly)


def gth_vloc_G0(pseudo):
    """Finite part at G=0 (the -4 pi Z/G^2 divergence cancels against the
    neutralising-background Hartree/Ewald convention)."""
    rloc, zion = pseudo.rloc, pseudo.zion
    c = np.zeros(4)
    c[: len(pseudo.cloc)] = pseudo.cloc
    return (2.0 * np.pi * zion * rloc ** 2
            + math.sqrt(8.0 * np.pi ** 3) * rloc ** 3
            * (c[0] + 3.0 * c[1] + 15.0 * c[2] + 105.0 * c[3]))


def vloc_on_grid(cell, dtype=None, *, device="cuda"):
    """Total local pseudopotential on the FFT grid: real (ngrid,) of
    ``dtype``.  The form factors are summed on the host in float64."""
    mesh = tuple(int(m) for m in cell.mesh)
    gv = cell.get_Gv()
    G2 = np.einsum("gi,gi->g", gv, gv)
    ng = G2.shape[0]
    f = np.zeros(ng, dtype=np.complex128)
    g0 = G2 <= 1e-12
    for sym, xyz in cell.atom:
        ps = cell._pseudo.get(sym)
        if ps is None:
            # all-electron point charge: v(G) = -4 pi Z / G^2, G=0 zeroed
            z = basis_data.ATOMIC_NUMBER[basis_data.element_symbol(sym)]
            vG = np.where(g0, 0.0, -4.0 * np.pi * z / np.where(g0, 1.0, G2))
        else:
            vG = gth_vloc_G(ps, G2)
            vG[g0] = gth_vloc_G0(ps)
        f += vG * np.exp(-1j * gv @ np.asarray(xyz))
    f_t = torch.as_tensor(f, dtype=real_complex(dtype)[1], device=device)
    return ifft3(f_t, mesh).real * (ng / cell.vol)


def get_vloc(cell, ao_kpts, vgrid=None):
    if vgrid is None:
        vgrid = vloc_on_grid(cell, dtype=ao_kpts.dtype,
                             device=ao_kpts.device)
    w = cell.vol / ao_kpts.shape[1]
    return w * (ao_kpts.mH @ (vgrid[None, :, None] * ao_kpts))


# -------------------------------------------------------------- nonlocal PSP
def _projector_shells(cell):
    """[(center, Shell)] for every GTH projector, plus the coupling matrix
    h (nproj_func, nproj_func) over the evaluator's flattened (shell-major,
    m-minor) function order."""
    shells = []
    blocks = []
    for sym, xyz in cell.atom:
        ps = cell._pseudo.get(sym)
        if ps is None:
            continue
        for (l, rl, h) in ps.projectors:
            ni = h.shape[0]
            if ni == 0:
                continue
            for i in range(1, ni + 1):
                # p_i^l(r) = sqrt(2) r^(l+2(i-1)) e^(-r^2/2rl^2)
                #            / (rl^(l+(4i-1)/2) sqrt(Gamma(l+(4i-1)/2)))
                nrm = math.sqrt(2.0) / (
                    rl ** (l + (4 * i - 1) / 2.0)
                    * math.sqrt(math.gamma(l + (4 * i - 1) / 2.0)))
                shells.append((np.asarray(xyz),
                               Shell(l=l, exps=np.array([0.5 / rl ** 2]),
                                     coeffs=np.array([[nrm]]),
                                     rpow=i - 1, raw=True)))
            blocks.append((ni, 2 * l + 1, h))
    ntot = sum(ni * nm for ni, nm, _ in blocks)
    hmat = np.zeros((ntot, ntot))
    off = 0
    for ni, nm, h in blocks:
        for i in range(ni):
            for j in range(ni):
                for m in range(nm):
                    hmat[off + i * nm + m, off + j * nm + m] = h[i, j]
        off += ni * nm
    return shells, hmat


def get_vnl(cell, ao_kpts, kpts):
    """Nonlocal GTH matrix V_k = B_k^H h B_k, B_k = w <p_k | phi_k>."""
    shells, hmat = _projector_shells(cell)
    nk, ng, nao = ao_kpts.shape
    dev = ao_kpts.device
    if not shells:
        return torch.zeros((nk, nao, nao), dtype=ao_kpts.dtype, device=dev)
    rdt = real_complex(ao_kpts.dtype)[0]
    p_k = make_evaluator(cell, kpts=kpts, dtype=rdt, shells=shells,
                         device=dev)(
        cell.gen_uniform_grids())                       # (nk, ng, nproj)
    b = (cell.vol / ng) * (p_k.mH @ ao_kpts)            # (nk, nproj, nao)
    del p_k
    h = torch.as_tensor(hmat, dtype=ao_kpts.dtype, device=dev)
    return b.mH @ h @ b


def get_hcore(cell, ao_kpts, kpts, coords=None):
    t = get_kinetic(cell, ao_kpts, kpts, coords)
    v = get_vloc(cell, ao_kpts)
    return t + v + get_vnl(cell, ao_kpts, kpts)


# ---------------------------------------------------------------------- Ewald
def _ewald_real_py(coords, charges, ts, eta):
    from scipy.special import erfc

    e_real = 0.0
    zz = charges[:, None] * charges[None, :]
    for t in ts:
        d = coords[:, None, :] - coords[None, :, :] + t[None, None, :]
        r = np.linalg.norm(d, axis=-1)
        if np.all(np.abs(t) < 1e-12):
            iu = ~np.eye(len(charges), dtype=bool)
            e_real += 0.5 * np.sum(zz[iu] * erfc(np.sqrt(eta) * r[iu])
                                   / r[iu])
        else:
            e_real += 0.5 * np.sum(zz * erfc(np.sqrt(eta) * r) / r)
    return float(e_real)


def ewald(cell, eta=None):
    """Ion-ion energy of point charges and a neutralising background.
    ``cell`` may be any object with ``atom_coords()``, ``atom_charges()``
    and ``a`` (the probe lattice of :func:`madelung` is one)."""
    return _ewald_points(np.asarray(cell.atom_coords(), dtype=float),
                         np.asarray(cell.atom_charges(), dtype=float),
                         np.asarray(cell.a, dtype=float), eta=eta)


def _ewald_points(coords, charges, a, eta=None):
    """Standard 3D Ewald energy of a point-charge set in the lattice ``a``."""
    vol = float(abs(np.linalg.det(a)))
    if eta is None:
        eta = np.pi / vol ** (2.0 / 3.0)
    rcut = np.sqrt(-np.log(1e-14) / eta)
    heights = np.array([
        vol / np.linalg.norm(np.cross(a[(i + 1) % 3], a[(i + 2) % 3]))
        for i in range(3)])
    nmax = np.ceil(rcut / heights).astype(int) + 1
    rng = [np.arange(-n, n + 1) for n in nmax]
    ints = np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
    ts = ints.astype(float) @ a
    e_real = native.ewald_real(coords, charges, ts, eta)
    if e_real is None:
        e_real = _ewald_real_py(coords, charges, ts, eta)
    gcut = 2.0 * np.sqrt(eta * -np.log(1e-14))
    b = 2.0 * np.pi * np.linalg.inv(a).T
    bh = 2 * np.pi / np.linalg.norm(a, axis=1)
    nmax = np.ceil(gcut / bh).astype(int) + 1
    rng = [np.arange(-n, n + 1) for n in nmax]
    ints = np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, 3)
    gs = ints.astype(float) @ b
    g2 = np.einsum("gi,gi->g", gs, gs)
    sel = g2 > 1e-12
    gs, g2 = gs[sel], g2[sel]
    sfac = np.exp(1j * gs @ coords.T) @ charges
    e_recip = (2.0 * np.pi / vol) * np.sum(
        np.exp(-g2 / (4.0 * eta)) / g2 * np.abs(sfac) ** 2)
    e_self = np.sqrt(eta / np.pi) * np.sum(charges ** 2)
    e_bg = np.pi / (2.0 * eta * vol) * np.sum(charges) ** 2
    return float(e_real + e_recip - e_self - e_bg)


def madelung(cell, kmesh) -> float:
    """Madelung constant of the Born-von-Karman supercell: ``-2 *`` the
    Ewald energy of one unit point charge (with its neutralising
    background) on the kmesh-scaled lattice.  It is the probe-charge
    correction of the q+G = 0 exchange term (``exxdiv='ewald'``)."""
    a_sc = np.asarray(kmesh, dtype=np.float64)[:, None] * np.asarray(cell.a)

    class _Probe:
        a = a_sc

        @staticmethod
        def atom_charges():
            return np.array([1.0])

        @staticmethod
        def atom_coords():
            return np.zeros((1, 3))

    return -2.0 * ewald(_Probe)


def get_ovlp_kpts(cell, kpts, dtype=None, blksize=None, *, device="cuda"):
    """Overlap S_k (nk, nao, nao) by grid quadrature in ``dtype``, streamed
    over grid blocks so that no full-grid AO tensor exists.  A block holds
    the (nk, blk, nao) AO values and the evaluator's temporaries; it is
    sized to a tenth of the device's free memory, and to at most
    ``blksize`` points when that is given."""
    device = resolve_device(device)
    rdt, cdt = real_complex(dtype)
    fn = make_evaluator(cell, kpts=kpts, dtype=rdt, device=device)
    coords = torch.as_tensor(cell.gen_uniform_grids(), dtype=rdt,
                             device=device)
    ng = coords.shape[0]
    nk, nao = len(kpts), fn.nao
    blk = int(max(64, min(ng, 0.1 * free_memory_bytes(device)
                          // (4 * nk * nao * cdt.itemsize))))
    if blksize is not None:
        blk = max(1, min(blk, int(blksize)))
    s = torch.zeros((nk, nao, nao), dtype=cdt, device=device)
    for g0 in range(0, ng, blk):
        f = fn(coords[g0:g0 + blk])
        s += f.mH @ f
    return s * (cell.vol / ng)
