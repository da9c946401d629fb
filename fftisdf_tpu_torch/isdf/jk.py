"""ISDF J/K from the built state (x_k, w_q): dense algebra.

Counterpart of ``fftisdf_tpu/isdf/jk.py``.

J:  vj[k]_{mn} = sum_I conj(x_{k,I,m}) x_{k,I,n} v_I,
    v = w_{q=0} rho,   rho_I = (1/nk) sum_k (x_k dm_k x_k^H)_{II}.

K:  the k2 sum is a convolution over the k-grid, diagonal in image space:
    with ws[R] = Re(sum_q phase[R,q] w_q) sqrt(nk) and the image-space
    density rhos[R] = Re(sum_k phase[R,k] rhok_k),
    vk_q = sum_R phase[R,q] (ws[R] (.) rhos[R]^T), vk[k] = x_k^H vk_q x_k
    (the transpose uses rhos[-R] = rhos[R]^T of time-reversal-symmetric
    densities).

Densities carry a leading set/spin axis (nset, nk, nao, nao); sets are
served one after another.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _rho_k(x_k, dm):
    """x_k dm_k x_k^H / nk per k: (nk, nip, nip)."""
    return (x_k @ dm @ x_k.mH) / x_k.shape[0]


def get_j_kpts(x_k, w0, dms):
    """vj (nset, nk, nao, nao) from dms (nset, nk, nao, nao)."""
    nk = x_k.shape[0]
    t = torch.matmul(x_k.unsqueeze(0), dms)               # (x, k, I, n)
    rho = (t * x_k.conj().unsqueeze(0)).sum(dim=(1, 3)) / nk  # (x, I)
    v = rho @ w0.T                                        # (x, I)
    return x_k.mH.unsqueeze(0) @ (v[:, None, :, None] * x_k.unsqueeze(0))


def add_ewald_exx(vk, s1e, dms, mad):
    """Probe-charge (``exxdiv='ewald'``) correction of the q+G = 0 exchange
    term: vk[k] += madelung S_k dm_k S_k, over any leading set axes."""
    return vk + mad * (s1e @ dms @ s1e)


def get_k_kpts(x_k, wq, phase, dms):
    """vk (nset, nk, nao, nao) by the plain phase-matrix algebra;
    ``phase`` (nimg, nk) is the unitary image DFT matrix.  The test oracle
    of :func:`get_k_kpts_img`."""
    nk, nip, _ = x_k.shape
    ws = (phase @ wq.reshape(nk, -1)).real * math.sqrt(nk)
    out = []
    for dm in dms:
        rhok = _rho_k(x_k, dm).reshape(nk, -1)
        rhos = (phase @ rhok).real.reshape(nk, nip, nip)
        vs = ws.reshape(nk, nip, nip) * rhos.transpose(1, 2)
        vk_q = (phase.T @ vs.reshape(nk, -1).to(phase.dtype))
        vk_q = vk_q.reshape(nk, nip, nip)
        out.append(x_k.mH @ vk_q @ x_k)
    return torch.stack(out)


def _phase_cs(kmesh, dtype, device):
    """cos/sin split of the image DFT matrix of the C-ordered k-grid:
    C + iS = e^{+2 pi i R.k_frac} / sqrt(nk), both (nk, nk) and
    symmetric."""
    ii = np.indices(tuple(kmesh)).reshape(len(kmesh), -1).T
    ang = 2.0 * np.pi * (ii @ (ii / np.asarray(kmesh)[None, :]).T)
    nk = ii.shape[0]
    c = torch.as_tensor(np.cos(ang) / np.sqrt(nk), dtype=dtype, device=device)
    s = torch.as_tensor(np.sin(ang) / np.sqrt(nk), dtype=dtype, device=device)
    return c, s


def wq_to_ws(wq, kmesh):
    """Image-space Coulomb metric ws[R] = Re(phase @ wq)[R] sqrt(nk), as a
    3D inverse FFT over the C-ordered k axis: real (nimg, nip, nip)."""
    nk = wq.shape[0]
    a = wq.reshape(*tuple(int(m) for m in kmesh), *wq.shape[1:])
    out = torch.fft.ifftn(a, dim=(0, 1, 2)).reshape(wq.shape)
    return out.real * nk


def get_k_kpts_img(x_k, ws, dms, kmesh, phase_cs=None, mesh=None):
    """vk from the precomputed image-space metric (:func:`wq_to_ws`); the
    algebra of :func:`get_k_kpts` with the two per-density phase
    contractions as real cos/sin matmuls:

        rhos = C Re(rhok) - S Im(rhok),   vk_q = (C + iS) vs.

    ``phase_cs``: (C, S) from :func:`_phase_cs`, made here when None.
    ``mesh``: a mesh of ranks (``parallel.mesh.DeviceMesh``) that splits
    the image axis: ``ws`` holds this rank's images ``mesh.owned(nk)``,
    the sum runs over those rows of C and S (both symmetric, so
    ``C.T vs`` is the transform back), and the ranks' partial vk are
    all-reduced."""
    nk, nip, _ = x_k.shape
    c, s = (_phase_cs(kmesh, ws.dtype, ws.device) if phase_cs is None
            else phase_cs)
    if mesh is not None:
        i0, i1 = mesh.owned(nk)
        c, s = c[i0:i1], s[i0:i1]
    nimg = ws.shape[0]
    ws_f = ws.reshape(nimg, -1)
    out = []
    for dm in dms:
        rhok = _rho_k(x_k, dm).reshape(nk, -1)
        rhos = c @ rhok.real - s @ rhok.imag
        vs = (ws_f * rhos.reshape(nimg, nip, nip).transpose(1, 2)
              .reshape(nimg, -1))
        vk_q = torch.complex(c.T @ vs, s.T @ vs).reshape(nk, nip, nip)
        out.append(x_k.mH @ vk_q @ x_k)
    vk = torch.stack(out)
    return vk if mesh is None else mesh.all_reduce(vk)
