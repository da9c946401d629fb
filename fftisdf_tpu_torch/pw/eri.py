"""Exact plane-wave ERIs for momentum-conserving k-point quadruples.

Counterpart of ``fftisdf_tpu/pw/eri.py``.  Convention:
eri[m,n,k,l] = (m k1, n k2 | k k3, l k4)
    = integral conj(phi_{k1,m}) phi_{k2,n} (1/r12) conj(phi_{k3,k}) phi_{k4,l}
with k2 - k1 + k4 - k3 = G; q = k2 - k1 mod G.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.linalg.fft import fft3
from fftisdf_tpu_torch.pw.poisson import eiqr, pair_potential
from fftisdf_tpu_torch.utils.device import as_tensor, real_complex


def get_ao_pairs_G(ao1, ao2, q, coords, mesh, sign=+1):
    """Fourier transform of the AO pair functions conj(ao1) ao2:
    (ngrid, nao*nao), FFT[conj(ao1_m) ao2_n e^{-i sign q.r}]."""
    ng = ao1.shape[0]
    rho = (ao1.conj()[:, :, None] * ao2[:, None, :]).reshape(ng, -1)
    ph = eiqr(as_tensor(coords, ao1.device, real_complex(ao1.dtype)[0]),
              -sign * np.asarray(q))
    return fft3((rho * ph[:, None]).T, mesh).T


def get_eri_from_ao(cell, aos, q, coords=None, mesh=None):
    """Exact ERI tensor (nao, nao, nao, nao) from Bloch AO values
    ``aos = (ao1, ao2, ao3, ao4)``, each (ngrid, nao) at k1..k4, with
    q = k2 - k1 (mod G)."""
    ao1, ao2, ao3, ao4 = aos
    mesh = cell.mesh if mesh is None else mesh
    if coords is None:
        coords = cell.gen_uniform_grids(mesh)
    ng, nao = ao1.shape
    rho12 = (ao1.conj()[:, :, None] * ao2[:, None, :]).reshape(ng, -1)
    v12 = pair_potential(rho12.T, q, coords, cell, mesh)      # (nao^2, ng)
    rho34 = (ao3.conj()[:, :, None] * ao4[:, None, :]).reshape(ng, -1)
    eri = (cell.vol / ng) * (v12 @ rho34)
    return eri.reshape(nao, nao, nao, nao)
