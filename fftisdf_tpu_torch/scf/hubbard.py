"""DFT+U (Dudarev's rotationally invariant scheme) for the KS drivers.

Counterpart of ``fftisdf_tpu/scf/hubbard.py``: DFT+U on the Ni d shell is
the production method for the NiO AFM system; a semilocal functional
alone neither opens its charge-transfer gap nor holds the AFM order.

Per selected (atom, l) site and spin channel (Dudarev et al., PRB 57,
1505 (1998)):

    E_U = sum_{I,sigma} U_I/2 * [ Tr n_I^sigma - Tr (n_I^sigma)^2 ]

with the on-site occupation matrix in the Loewdin-orthonormalised AO
projector subspace, n_I,ij^sigma = (1/nk) sum_k [S_k^1/2 D_k^sigma
S_k^1/2]_{I_i, I_j}.  The projector is the first contracted radial of each
m channel of the first l-shell on the atom; explicit AO index lists can be
passed instead.  The Fock term, in the energy pairing of ``scf.hf``
(einsum("kmn,knm->", dm, V)/nk), is

    V_k^sigma = S_k^1/2 P^T [ U/2 (1 - 2 n^sigma) ] P S_k^1/2 ;

restricted drivers use n^sigma = n_total/2.  U is in Hartree.

The host functions are numpy, as in the JAX package, with batched matmuls
where it has three-operand einsums (numpy runs those as one loop nest,
O(nao^4) a k-point);
:func:`eu_and_vu_traced` and :func:`sqrtm_traced` are their torch
counterparts on device tensors (the device-resident loop and, later, the
derivative suite).
"""
from __future__ import annotations

import numpy as np
import torch


def projector_indices(cell, ia, l):
    """AO indices of the first-radial projector functions of the first
    l-shell on atom ``ia`` (one AO per m channel, 2l+1 in all).  Within a
    shell the (2l+1, nctr) block is m-major, contracted-radial-minor."""
    off = 0
    for ja, _sym, _xyz, sh in cell.shells():
        if ja == ia and sh.l == l:
            return np.asarray([off + m * sh.nctr for m in range(2 * l + 1)])
        off += sh.nfunc
    raise ValueError(f"atom {ia} has no l={l} shell")


def shalf_kpts(s1e):
    """Hermitian S_k^1/2 per k-point (host, f64)."""
    s1e = np.asarray(s1e)
    out = np.empty_like(s1e)
    for k in range(s1e.shape[0]):
        se, sv = np.linalg.eigh(s1e[k])
        out[k] = (sv * np.sqrt(np.maximum(se, 0.0))) @ sv.conj().T
    return out


def build_sites(cell, hubbard):
    """Normalise the ``hubbard`` spec to [(idx array, U), ...]:
    {atom_index: (l, U)} with the first-radial projector, or
    {atom_index: (indices, U)} with an explicit AO index list."""
    sites = []
    for ia, (sel, u) in sorted(hubbard.items()):
        idx = (projector_indices(cell, ia, int(sel))
               if np.isscalar(sel) else np.asarray(sel, dtype=int))
        sites.append((idx, float(u)))
    return sites


def occupation_matrices(dm, shalf, sites):
    """Per-site on-site occupation matrices [n (nspin, p, p), ...] of the
    spin-resolved ``dm`` (nspin, nk, nao, nao) (restricted callers pass
    dm_total/2 per channel); ``shalf`` (nk, nao, nao)."""
    dm = np.asarray(dm)
    sd = (shalf @ dm @ shalf).mean(axis=1)        # (nspin, nao, nao), 1/nk
    out = []
    for idx, _u in sites:
        n = sd[:, idx[:, None], idx[None, :]]
        out.append(0.5 * (n + np.conj(np.swapaxes(n, -1, -2))))
    return out


def eu_and_vu(dm, shalf, sites):
    """(E_U, V_U, g) for the spin-resolved dm (nspin, nk, nao, nao).

    V_U pairs with dm in the package's energy convention,
    dE_U = einsum("skmn,sknm->", d dm, V_U) / nk; ``g`` (nspin, nao, nao)
    is the potential in the Loewdin frame: V at any k-point set is
    S_k^1/2 g S_k^1/2 (:func:`vu_from_g`)."""
    dm = np.asarray(dm)
    nspin, _, nao = dm.shape[:3]
    occ = occupation_matrices(dm, shalf, sites)
    e_u = 0.0
    g = np.zeros((nspin, nao, nao), dtype=dm.dtype)
    for (idx, u), n in zip(sites, occ):
        for s in range(nspin):
            ns = n[s]
            e_u += 0.5 * u * np.real(np.trace(ns) - np.trace(ns @ ns))
            g[s][idx[:, None], idx[None, :]] += \
                0.5 * u * (np.eye(len(idx)) - 2.0 * ns)
    return float(e_u), vu_from_g(shalf, g), g


def vu_from_g(shalf, g):
    """V_U (nspin, nk, nao, nao) from the Loewdin-frame potential g."""
    return shalf @ g[:, None] @ shalf


def sqrtm_traced(s, iters=24):
    """Hermitian positive-semidefinite matrix square root (batched
    tensors) that autograd can differentiate everywhere.

    Denman-Beavers iteration (Y -> S^1/2, Z -> S^-1/2) with trace scaling:
    smooth in S, so gradients stay defined where S has degenerate
    eigenvalues, where the eigh-based :func:`shalf_kpts` would divide by
    eigenvalue gaps."""
    n = s.shape[-1]
    scale = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1).real / n
    y = s / scale[..., None, None].to(s.dtype)
    z = torch.eye(n, dtype=s.dtype, device=s.device).expand(s.shape)
    for _ in range(iters):
        zi = torch.linalg.inv(z)
        yi = torch.linalg.inv(y)
        y, z = 0.5 * (y + zi), 0.5 * (z + yi)
    return y * torch.sqrt(scale)[..., None, None].to(s.dtype)


def eu_and_vu_traced(dm, shalf, sites):
    """Torch counterpart of :func:`eu_and_vu` on device tensors, for the
    device-resident SCF loop: the same math and energy pairing.

    ``dm`` (nspin, nk, nao, nao) and ``shalf`` (nk, nao, nao) are tensors
    on one device; ``sites`` is the [(idx, U), ...] list of
    :func:`build_sites`.  Returns (E_U 0-d real tensor, V_U (nspin, nk,
    nao, nao))."""
    nspin, _, nao = dm.shape[:3]
    sd = (shalf @ dm @ shalf).mean(dim=1)
    e_u = torch.zeros((), dtype=dm.real.dtype, device=dm.device)
    g = torch.zeros((nspin, nao, nao), dtype=dm.dtype, device=dm.device)
    for idx, u in sites:
        it = torch.as_tensor(idx, device=dm.device)
        n = sd[:, it[:, None], it[None, :]]
        n = 0.5 * (n + n.mH)
        eye = torch.eye(len(idx), dtype=dm.dtype, device=dm.device)
        for s in range(nspin):
            ns = n[s]
            e_u = e_u + 0.5 * u * torch.real(
                torch.trace(ns) - torch.trace(ns @ ns))
            g[s, it[:, None], it[None, :]] += 0.5 * u * (eye - 2.0 * ns)
    return e_u, shalf @ g[:, None] @ shalf
