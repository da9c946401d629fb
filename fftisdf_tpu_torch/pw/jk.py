"""Exact plane-wave J/K at mesh k-points (the FFTDF-equivalent oracle).

Counterpart of ``fftisdf_tpu/pw/jk.py``: the slow exact method that ISDF
is measured against.  Density-matrix convention: dm[k]_{mn} with electron
density n(r) = (1/nk) sum_k sum_{mn} dm[k]_{mn} phi_{k,m}(r)
conj(phi_{k,n}(r)).

The exchange sweep solves one periodic Poisson problem per (k1, k2) pair
and AO pair (m, n): nk^2 nao^2 FFTs and inverse FFTs of the full mesh.
Work items (k-pair, bra row m) are batched into one ``torch.fft.fftn``
over the last three axes, as many as a byte budget holds (a quarter of
the device's free memory unless ``max_memory_gb`` is given); when one
pair's nao rows do not fit, the pair's bra rows are split into blocks.
Partial sums go into vk with ``index_add_`` on the device, and the loop
makes no host synchronisation.

The AO tensor's precision (complex128 or complex64) is the oracle's.
``omega`` selects a range-separated kernel and ``trunc`` a truncated one,
in the convention of ``linalg.coulomb``.  Band k-points (``ao_band``,
``kpts_band``) pair band rows with the mesh: the exact band path.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fftisdf_tpu_torch.linalg.coulomb import (_coulG_vec, _screen,
                                              check_trunc, get_coulG)
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.pw.poisson import eiqr
from fftisdf_tpu_torch.utils.device import (as_tensor, free_memory_bytes,
                                            real_complex)

# complex temporaries of one work item (k-pair, bra row) per AO and grid
# point: the pair density, its transform, cuFFT's workspace, the potential
_ITEM_TEMPS = 4
# the argmin exclusion takes a sample only when it lies below the threshold
# by more than this relative margin: the off-diagonal pairs of a mesh point
# sit exactly at it in exact arithmetic, and rounding must not drop them
ARGMIN_TIE = 1e-9


def get_j_kpts(cell, dm_kpts, ao_kpts, mesh=None, ao_band=None, omega=0.0,
               trunc=None):
    """Hartree matrix vj (nk, nao, nao) from AO values ao_kpts
    (nk, ngrid, nao) on their device.  ``ao_band`` (nb, ngrid, nao):
    integrate the mesh density's Hartree potential against band-point AOs
    instead, (nb, nao, nao); the potential is k-independent, so bands need
    no new Poisson solve."""
    mesh = tuple(int(m) for m in (cell.mesh if mesh is None else mesh))
    nk, ng, _ = ao_kpts.shape
    dev = ao_kpts.device
    rdt, cdt = real_complex(ao_kpts.dtype)
    dm = as_tensor(dm_kpts, dev, cdt)
    coulG = get_coulG(cell, mesh=mesh, omega=omega, trunc=trunc, dtype=rdt,
                      device=dev)
    n_g = ((ao_kpts @ dm) * ao_kpts.conj()).sum(dim=(0, 2)) / nk
    vcoul = ifft3(fft3(n_g, mesh) * coulG, mesh)
    ao_out = ao_kpts if ao_band is None else ao_band
    return (cell.vol / ng) * (ao_out.mH @ (vcoul[None, :, None] * ao_out))


def _pair_plan(nk, ng, nao, budget, itemsize=16):
    """(pairs per batch, bra rows per batch) for a byte budget."""
    per_row = _ITEM_TEMPS * nao * ng * itemsize
    rows = max(1, int(budget // per_row))
    if rows >= nao:
        return min(nk * nk, rows // nao), nao
    return 1, rows


def get_k_kpts(cell, dm_kpts, ao_kpts, kpts, mesh=None, coords=None,
               ao_band=None, kpts_band=None, g0_thresh=1e-12,
               g0_argmin_thresh=None, omega=0.0, trunc=None,
               max_memory_gb=None):
    """Exchange matrix vk (nk, nao, nao) by exact pairwise Poisson solves.

    vk[k1]_{mn} = (w/nk) sum_{k2,g,l} V^{k1k2}_{ml}(g) u^{k2}_l(g)
    ao_{k1,n}(g), with V^{k1k2}_{ml} the potential of the pair density
    conj(ao_{k1,m}) ao_{k2,l} (momentum q = k2 - k1), u^{k2} =
    conj(ao_{k2}) dm_{k2}^T and w = vol/ngrid.

    ``ao_band``/``kpts_band`` (nb, ngrid, nao)/(nb, 3): vk at band
    k-points instead, (nb, nao, nao); the pairs become (band kb, mesh k2),
    and the density stays on the mesh.

    ``g0_thresh``: kernel samples with |q+G|^2 at or below it are excluded;
    the default removes exactly the singular q+G = 0 term (the
    ``exxdiv=None`` convention).  ``g0_argmin_thresh`` (band paths): off
    the mesh no sample is exactly zero, but one falls arbitrarily close to
    the singularity; when set, exactly the argmin-|q+G|^2 sample of each
    (row, mesh) pair is excluded if its |q+G|^2 lies strictly below it.
    Callers pass (minimum q-lattice plane spacing)^2: at mesh points the
    rule reduces to dropping the q+G = 0 term (the off-diagonal pairs sit
    at the threshold, and a sample within ``ARGMIN_TIE`` of it, relative,
    is kept, so rounding cannot drop them), and off the mesh it drops
    exactly one sample for any q closer than that spacing to the singular
    lattice (argmin, not a radius, keeps the count at one near
    Wigner-Seitz corners, where several images tie).  ``omega``: range-separated kernel; the
    long-range (erf, omega > 0) divergence is dropped like the bare
    kernel's, the short-range (erfc, omega < 0) kernel takes its finite
    limit pi/omega^2 at the samples at or below ``g0_thresh``.  ``trunc``:
    a truncated kernel is finite everywhere, so nothing is excluded.
    ``max_memory_gb``: the batch's byte budget (default: a quarter of the
    device's free memory)."""
    omega = float(omega)
    trunc = check_trunc(trunc, omega)
    mesh = tuple(int(m) for m in (cell.mesh if mesh is None else mesh))
    if coords is None:
        coords = cell.gen_uniform_grids(mesh)
    nk, ng, nao = ao_kpts.shape
    dev = ao_kpts.device
    rdt, cdt = real_complex(ao_kpts.dtype)
    dm = as_tensor(dm_kpts, dev, cdt)
    kpts_t = as_tensor(np.asarray(kpts), dev, rdt)
    if ao_band is None:
        ao_row, kpts_row = ao_kpts, kpts_t
    else:
        ao_row = ao_band
        kpts_row = as_tensor(np.asarray(kpts_band).reshape(-1, 3), dev, rdt)
    nrow = ao_row.shape[0]
    coords_t = as_tensor(coords, dev, rdt)
    gv = as_tensor(cell.get_Gv(mesh), dev, rdt)
    u = ao_kpts.conj() @ dm.transpose(1, 2)                # (nk, ng, nao)
    budget = (0.25 * free_memory_bytes(dev) if max_memory_gb is None
              else float(max_memory_gb) * 1e9)
    pb, rb = _pair_plan(nk, ng, nao, budget, cdt.itemsize)
    vk = torch.zeros((nrow, nao, nao), dtype=cdt, device=dev)
    scale = cell.vol / ng / nk
    npair = nrow * nk
    for p0 in range(0, npair, pb):
        pidx = torch.arange(p0, min(p0 + pb, npair), device=dev)
        k1, k2 = pidx // nk, pidx % nk
        np_ = pidx.shape[0]
        q = kpts_t[k2] - kpts_row[k1]                      # (P, 3)
        ph = eiqr(coords_t, q)                             # (P, ng)
        gk = gv[None] + q[:, None, :]
        if trunc is not None:
            coulG = _coulG_vec(gk, 0.0, trunc)
        else:
            absg2 = (gk * gk).sum(dim=-1)
            nonzero = absg2 > g0_thresh
            keep = nonzero
            if g0_argmin_thresh is not None:
                imin = torch.argmin(absg2, dim=1, keepdim=True)
                near = torch.zeros_like(keep).scatter_(
                    1, imin, absg2.gather(1, imin)
                    < g0_argmin_thresh * (1.0 - ARGMIN_TIE))
                keep = keep & ~near
            one = torch.ones_like(absg2)
            coulG = torch.where(keep,
                                4.0 * math.pi / torch.where(keep, absg2, one),
                                torch.zeros_like(absg2))
            if omega > 0:
                coulG = coulG * _screen(absg2, omega)
            elif omega < 0:
                coulG = torch.where(
                    nonzero, coulG * (1.0 - _screen(absg2, omega)),
                    math.pi / (omega * omega) * one)
        coulG = coulG.reshape(np_, 1, 1, *mesh)
        a1 = ao_row[k1]                                    # (P, ng, nao)
        b2 = (ao_kpts[k2] * ph.conj()[:, :, None]).transpose(1, 2)
        b2 = b2.contiguous()                               # (P, nao, ng)
        u2 = u[k2].transpose(1, 2)                         # (P, nao, ng)
        for r0 in range(0, nao, rb):
            r1 = min(r0 + rb, nao)
            a1c = a1[:, :, r0:r1].conj().transpose(1, 2).contiguous()
            rho = (a1c[:, :, None, :] * b2[:, None, :, :]).reshape(
                np_, r1 - r0, nao, *mesh)
            work = torch.fft.fftn(rho, dim=(-3, -2, -1))
            del rho
            work.mul_(coulG)
            v = torch.fft.ifftn(work, dim=(-3, -2, -1))
            del work
            v = v.reshape(np_, r1 - r0, nao, ng)
            v.mul_(u2[:, None])
            tm = v.sum(dim=2) * ph[:, None, :]             # (P, rows, ng)
            del v
            vk[:, r0:r1].index_add_(0, k1, (tm @ a1) * scale)
    return vk


def get_jk_kpts(cell, dm_kpts, ao_kpts, kpts, mesh=None, coords=None,
                with_j=True, with_k=True, omega=0.0, trunc=None):
    """(vj, vk) exact plane-wave build with the kernel of ``omega`` and
    ``trunc``; either may be None if not requested."""
    vj = (get_j_kpts(cell, dm_kpts, ao_kpts, mesh, omega=omega, trunc=trunc)
          if with_j else None)
    vk = (get_k_kpts(cell, dm_kpts, ao_kpts, kpts, mesh, coords, omega=omega,
                     trunc=trunc)
          if with_k else None)
    return vj, vk
