"""ISDF-compact 3-index Cholesky factors ("cderi", the GDF analogue).

Counterpart of ``fftisdf_tpu/isdf/cderi.py``.  The built state (x_k, w_q)
is a compact quadratic form, so the hermitised metric's square root

    w_q ~= cd_q^H diag(sign_q) cd_q,   cd_q[P, I] = sqrt(|s_P|) conj(U[I, P])
    (w_h = U diag(s) U^H; sign_q = 1 and s clipped at 0 for the PSD form)

turns every ERI into the GDF pairing with naux = nip auxiliaries:

    eri((k1 k2)|(k3 k4)) = sum_P sign_P A_{k1k2}[P, mn] conj(A_{k4k3}[P, sl])
    A_{k1k2}[P, mn] = sum_I conj(cd_q[P, I]) conj(x_{k1,I,m}) x_{k2,I,n},
    q = k2 - k1 (mod G).

:func:`get_jk_cderi` runs the GDF algorithm, per-(k1, k2) half transforms
of the 3-index factor, not the ISDF image-space serve: the (nk^2, naux,
nao^2) tensor never exists; each k1 row regenerates its (k2_chunk, naux,
nao, nao) slabs and consumes them at once, as the JAX package's
``lax.scan`` does.  ``torch.linalg.eigh`` does the batched factorisation.
Tensors stay on the device of the state.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.utils.device import as_tensor


def _hermitised_eigh(wq):
    w_h = 0.5 * (wq + wq.mH)
    return torch.linalg.eigh(w_h)


def wq_to_cd(wq):
    """PSD square-root factors cd (nk, nip, nip): w_h[q] ~= cd_q^H cd_q,
    negative eigenvalues (fit noise) clipped.  The clipped mass is not
    negligible in float32; :func:`wq_to_cd_signed` keeps it."""
    s, u = _hermitised_eigh(wq)
    root = torch.sqrt(torch.clamp(s, min=0.0)).to(wq.dtype)
    return root[:, :, None] * u.mH


def wq_to_cd_signed(wq):
    """Signed square-root factors: w_h[q] = cd_q^H diag(sign_q) cd_q to
    eigh roundoff, cd = sqrt(|s|) U^H, sign = sign(s) (real).  The fitting
    metric is indefinite at the fit-noise level and the ISDF serve uses it
    as it is; the sign keeps the cderi serve exact."""
    s, u = _hermitised_eigh(wq)
    root = torch.sqrt(s.abs()).to(wq.dtype)
    return root[:, :, None] * u.mH, torch.sign(s)


def pair_cderi(cd_q, x1, x2):
    """A_{k1k2} (naux, n1, n2) of one k-pair: the GDF 3-index factor."""
    nip = x1.shape[0]
    t12 = (x1.conj()[:, :, None] * x2[:, None, :]).reshape(nip, -1)
    return (cd_q.conj() @ t12).reshape(cd_q.shape[0], x1.shape[1],
                                       x2.shape[1])


def assemble_eri_cderi(cd_q, x1, x2, x3, x4, sign_q=None):
    """ERI (n1, n2, n3, n4) through the GDF pairing
    sum_P sign_P A12[P, mn] conj(A43[P, sl]) (``sign_q=None``: the
    PSD-clipped convention)."""
    a12 = pair_cderi(cd_q, x1, x2)
    a43 = pair_cderi(cd_q, x4, x3)
    if sign_q is not None:
        a12 = a12 * sign_q[:, None, None].to(a12.dtype)
    naux, n1, n2 = a12.shape
    _, n4, n3 = a43.shape
    out = a12.reshape(naux, -1).T @ a43.conj().reshape(naux, -1)
    return out.reshape(n1, n2, n4, n3).transpose(2, 3)


def get_jk_cderi(x_k, cd, q_of, dm, k2_chunk=None, sign=None):
    """J/K (nk, nao, nao) each, from the compact factors, GDF style, for
    one density ``dm`` (nk, nao, nao).

    x_k (nk, nip, nao); cd (nk, naux, nip) the per-sector factors; q_of
    (nk, nk) with q_of[k1, k2] the sector of k2 - k1
    (:func:`q_index_table`); ``sign`` (nk, naux) from
    :func:`wq_to_cd_signed` (None: the PSD-clipped factors).

    J uses the q = 0 factor only (two aux-space products, the GDF J).  K
    loops over k1 and, within a row, over blocks of ``k2_chunk`` k2 (it
    must divide nk; None: the whole row): the block's (k2_chunk, naux,
    nao, nao) slab of A is regenerated and contracted with the density at
    once, vk[k1]_{ms} = (1/nk) sum_{k2,P,l} s_P G[P,m,l] conj(A[P,s,l]),
    G = A dm[k2]."""
    nk, nip, nao = x_k.shape
    naux = cd.shape[1]
    dev, cdt = x_k.device, x_k.dtype
    k2_chunk = int(k2_chunk or nk)
    if nk % k2_chunk:
        raise ValueError(f"k2_chunk {k2_chunk} must divide nk {nk}")
    q_of = as_tensor(np.asarray(q_of) if not isinstance(q_of, torch.Tensor)
                     else q_of, dev, torch.int64)
    dm = as_tensor(dm, dev, cdt)
    sgn = None if sign is None else as_tensor(sign, dev, cdt)

    # J: rho_I = (1/nk) sum_k (x dm x^H)_II; two aux-space products
    rho = ((x_k @ dm) * x_k.conj()).sum(dim=(0, 2)) / nk
    vaux = cd[0] @ rho
    if sgn is not None:
        vaux = vaux * sgn[0]
    v = cd[0].mH @ vaux
    vj = x_k.mH @ (v[None, :, None] * x_k)

    # K: one (k2_chunk, naux, nao, nao) slab of A at a time
    vk = torch.empty((nk, nao, nao), dtype=cdt, device=dev)
    xc = x_k.conj()
    for k1 in range(nk):
        acc = torch.zeros((nao, nao), dtype=cdt, device=dev)
        for c0 in range(0, nk, k2_chunk):
            k2s = slice(c0, c0 + k2_chunk)
            qs = q_of[k1, k2s]
            t12 = (xc[k1][None, :, :, None] * x_k[k2s][:, :, None, :])
            a = cd[qs].conj() @ t12.reshape(-1, nip, nao * nao)
            a = a.reshape(-1, naux, nao, nao)            # (c, P, m, n)
            g = a @ dm[k2s][:, None]                     # (c, P, m, l)
            if sgn is not None:
                g = g * sgn[qs][:, :, None, None]
            # sum_{c,P,l} g[c,P,m,l] conj(a[c,P,s,l])
            acc += (g.permute(2, 0, 1, 3).reshape(nao, -1)
                    @ a.conj().permute(0, 1, 3, 2).reshape(-1, nao))
        vk[k1] = acc / nk
    return vj, vk


def q_index_table(cell, kpts):
    """q_of[k1, k2] = sector index of k2 - k1 (host, int32)."""
    s = cell.get_scaled_kpts(np.asarray(kpts))
    nk = len(s)
    q_of = np.empty((nk, nk), dtype=np.int32)
    for k1 in range(nk):
        for k2 in range(nk):
            q_of[k1, k2] = kpt_mod.member(s[k2] - s[k1], s, strict=False)
    if not (q_of >= 0).all():
        raise ValueError("k-mesh not closed under differences")
    return q_of
