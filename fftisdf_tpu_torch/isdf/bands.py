"""J/K at arbitrary band k-points served from the ISDF product state.

Counterpart of ``fftisdf_tpu/isdf/bands.py``.  The pair density of one
(band b, mesh k2) pair,

    rho^{b,k2}_{mn}(r) = conj(phi_{b,m}(r)) phi_{k2,n}(r)
                      ~= sum_I xi_I(r) conj(x_{b,I,m}) x_{k2,I,n},

is fitted by least squares over the frozen interpolation points.  The
normal matrix and the RHS factor elementwise over the interpolation index,

    A      = (x_b x_b^H) (.) conj(x_{k2} x_{k2}^H)         (nip, nip)
    B[g,I] = fx_b[g,I] conj(fx_{k2}[g,I]),  fx_k = conj(f_k) x_k^T,

and the pair metric w^{b,k2} = S (B^T K_{q'} B^*) S goes through the
build's metric-side assembly (``isdf.kpoint._sector_wq``) with the
off-mesh momentum q' = k2 - b in the kernel.  Exchange is

    vk[b] = (1/nk) sum_{k2} x_b^H (w^{b,k2} (.) rho_{k2}) x_b,
    rho_{k2} = x_{k2} D_{k2} x_{k2}^H.

Hartree fits the (b, b) pair too (the mesh q = 0 fitting functions do not
span band diagonal densities) and integrates it against the mesh
density's Hartree potential: v_I = (vol/ng) [S_bb (B_bb^T vcoul)]_I,
vj[b] = x_b^H diag(v) x_b, vcoul = ifft(coulG fft(n_mesh)).

The exchange kernel's G = 0 handling follows the exact band path
(``pw.jk``): exactly the argmin-|q'+G|^2 sample is dropped when it lies
strictly inside the minimum q-lattice plane spacing, by more than the
rounding margin ``ARGMIN_TIE``.  A truncated kernel
is finite everywhere and keeps every sample; its negative samples enter
the metric with their sign.

The band and mesh AOs on the full grid stay on the device; the (ngrid,
nip) RHS buffer is allocated once and refilled for every (b, k2) pair.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf.kpoint import _sector_wq
from fftisdf_tpu_torch.linalg.coulomb import get_coulG
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.linalg.solvers import fitting_operator
from fftisdf_tpu_torch.pw.jk import ARGMIN_TIE
from fftisdf_tpu_torch.pw.poisson import eiqr
from fftisdf_tpu_torch.utils.device import as_tensor


def _band_coulG(cell, q, gv, dmin2):
    """4 pi/|q+G|^2 with the band argmin-exclusion rule (host, real); a
    sample at ``dmin2`` up to rounding is kept (``pw.jk.ARGMIN_TIE``)."""
    gk = gv + q[None, :]
    absg2 = np.einsum("gi,gi->g", gk, gk)
    keep = absg2 > 1e-12
    imin = int(np.argmin(absg2))
    if absg2[imin] < dmin2 * (1.0 - ARGMIN_TIE):
        keep[imin] = False
    out = np.zeros_like(absg2)
    out[keep] = 4.0 * np.pi / absg2[keep]
    return out


def _qlat_dmin2(cell, kmesh):
    """(minimum BvK q-lattice plane spacing)^2."""
    km = np.asarray(kmesh, dtype=np.float64)
    qlat = cell.reciprocal_vectors() / km[:, None]
    volq = abs(np.linalg.det(qlat))
    dmin = min(volq / np.linalg.norm(
        np.cross(qlat[(i + 1) % 3], qlat[(i + 2) % 3])) for i in range(3))
    return dmin ** 2


def _pair_gram(x1, x2):
    """(x1 x1^H) (.) conj(x2 x2^H): the normal matrix of one pair."""
    return (x1 @ x1.mH) * (x2 @ x2.mH).conj()


def get_jk_bands(df, dm_kpts, kpts_band, with_j=True, with_k=True):
    """(vj_b, vk_b) at band k-points, each (nset?, nb, nao, nao) with the
    rank of the input density ((nk, nao, nao) -> (nb, nao, nao)); None for
    a skipped part.  ``df`` is a built FFTISDF."""
    cell, kpts, dev = df.cell, df.kpts, df.device
    rdt, cdt = df.rdtype, df.cdtype
    nk = len(kpts)
    kpts_band = np.asarray(kpts_band, dtype=np.float64).reshape(-1, 3)
    nb = len(kpts_band)
    mesh = tuple(int(m) for m in cell.mesh)
    coords = torch.as_tensor(cell.gen_uniform_grids(), dtype=rdt, device=dev)
    ngrid = coords.shape[0]
    vol = float(cell.vol)
    gv = cell.get_Gv(mesh)
    dmin2 = _qlat_dmin2(cell, df.kmesh)

    dm = as_tensor(dm_kpts, dev, cdt)
    single = dm.ndim == 3
    dms = dm[None] if single else dm
    nset, _, nao, _ = dms.shape

    # band AOs at the frozen interpolation points and on the full grid
    coords_ip = cell.gen_uniform_grids(df.m0)[np.asarray(df.mask)]
    fnb = make_evaluator(cell, kpts=kpts_band, dtype=rdt, device=dev)
    x_b = fnb(coords_ip)                                  # (nb, nip, nao)
    f_b = fnb(coords)                                     # (nb, ng, nao)
    f_k = make_evaluator(cell, kpts=kpts, dtype=rdt, device=dev)(coords)
    x_k = df.x_k
    nip = x_k.shape[1]

    vj_b = None
    if with_j:
        coulG0 = get_coulG(cell, mesh=mesh, trunc=df.trunc, dtype=rdt,
                           device=dev)
        n_g = torch.stack([((f_k @ d) * f_k.conj()).sum(dim=(0, 2)).real
                           for d in dms]) / nk            # (nset, ng)
        vcoul = ifft3(fft3(n_g.to(cdt), mesh) * coulG0, mesh).real.to(cdt)
        out = []
        for b in range(nb):
            fx = f_b[b].conj() @ x_b[b].T                 # (ng, nip)
            b_bb = fx * fx.conj()
            rhs = (vol / ngrid) * (vcoul @ b_bb.conj())   # (nset, nip)
            apply_inv, _ = fitting_operator(
                _pair_gram(x_b[b], x_b[b]), method=df.solver,
                rcond=df.rcond, refine=df.refine)
            v = apply_inv(rhs.T).T                        # (nset, nip)
            out.append(x_b[b].mH[None] @ (v[:, :, None] * x_b[b][None]))
        vj_b = torch.stack(out, dim=1)                    # (nset, nb, ...)
        if single:
            vj_b = vj_b[0]
    if not with_k:
        return vj_b, None

    # rho_{k2} = x_{k2} D_{k2} x_{k2}^H for every set, once
    rho = x_k[None] @ dms @ x_k.mH[None]                  # (nset, nk, I, J)
    buf = torch.empty((ngrid, nip), dtype=cdt, device=dev)
    vk_b = torch.empty((nset, nb, nao, nao), dtype=cdt, device=dev)
    for b in range(nb):
        fx_b = f_b[b].conj() @ x_b[b].T                   # (ng, nip)
        acc_vk = torch.zeros((nset, nao, nao), dtype=cdt, device=dev)
        for k2 in range(nk):
            # buf = fx_b conj(fx_{k2}), formed in place
            torch.matmul(f_k[k2].conj(), x_k[k2].T, out=buf)
            buf.conj_physical_().mul_(fx_b)
            q = kpts[k2] - kpts_band[b]
            neg_cols = None
            if df.trunc is not None:
                # finite everywhere: no divergent-sample exclusion
                cg = get_coulG(cell, q=q, gv=gv, trunc=df.trunc, dtype=rdt,
                               device=dev)
                # off-mesh shifts make a truncated 2D kernel negative at
                # many samples: they enter the metric with their sign
                neg_cols = torch.nonzero(cg < 0)[:, 0]
            else:
                cg = torch.as_tensor(_band_coulG(cell, q, gv, dmin2),
                                     dtype=rdt, device=dev)
            w = _sector_wq(_pair_gram(x_b[b], x_k[k2]), buf, cg,
                           eiqr(coords, q), mesh, vol, solver=df.solver,
                           rcond=df.rcond, refine=df.refine,
                           neg_cols=neg_cols)
            acc_vk += x_b[b].mH[None] @ (w[None] * rho[:, k2]) @ x_b[b][None]
        vk_b[:, b] = acc_vk / nk
    if single:
        vk_b = vk_b[0]
    return vj_b, vk_b
