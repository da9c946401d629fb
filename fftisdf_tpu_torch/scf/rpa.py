"""Direct RPA correlation energy in the ISDF interpolation basis.

Counterpart of ``fftisdf_tpu/scf/rpa.py``.  The ring couplings factorise
as ``(ai|jb) = (A_q^H w_q A_q)_{(ia),(jb)}`` with ``A_{I,(k,ia)} =
conj(xo_k)_{Ii} xv_{k_a}_{Ia}``, so the RPA ring series contracts to the
nip x nip fitting space by the determinant identity

    det(1 - V G) = det(1 - w_q chi_q(iw)),
    chi_q(iw) = sum_p g_p(iw) A[:, p] A[:, p]^H,

one (nip, npair) x (npair, nip) product and one nip x nip slogdet per
(q, iw) sample.  Closed-shell, insulating occupations:

    E_c = (1/2pi nk) sum_q  int_0^inf dw  Re[ln det(1 - K_q(iw)) + tr K_q],
    K_q = (1/nk) w_q chi_q(iw),   g_p(iw) = -4 Delta_p / (Delta_p^2 + w^2)

(-4 = 2 spins x 2 time orderings; the 1/nk on K and the 1/nk in front
block-diagonalise the Bloch pair space of the supercell).  Frequency
integration: Gauss-Legendre on w = t/(1-t).  The frequencies of one sector
run as one batched slogdet, in blocks sized from the device's free memory.
Tensors stay on the device of the ISDF state.

The port departs from the JAX package in chi: the JAX package contracts
A g A^T.  A pair (i k, a k+q) enters the bubble once as conj(phi_i) phi_a
and once conjugated, so chi is A g A^H: Hermitian, momentum-conserving in
every sector, and unchanged when an orbital is multiplied by a phase.
A g A^T is none of these unless the orbitals are real (gamma, or a
time-reversal invariant k-point in a real gauge), where the two agree; on
diamond 1x1x2 with PBE orbitals given random phases, the JAX form moves
the dRPA energy by 0.17 Ha.  chi here is shared by ``scf.gw`` and
``scf.bse``.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.scf.mp2 import _mo_blocks, _pair_mat
from fftisdf_tpu_torch.utils.device import memory_blocks


def _freq_grid(nw):
    """Gauss-Legendre nodes/weights for int_0^inf dw via w = t/(1-t)."""
    t, wt = np.polynomial.legendre.leggauss(nw)
    t = 0.5 * (t + 1.0)
    wt = 0.5 * wt
    omega = t / (1.0 - t)
    weight = wt / (1.0 - t) ** 2
    return omega, weight


def _freq_blocks(nw, pair_amp, ntemp=4):
    """Frequency slices whose (nip, npair) scaled amplitudes and ``ntemp``
    (nip, nip) matrices a frequency fit in free memory."""
    nip, npair = pair_amp.shape
    return memory_blocks(nw, (ntemp * nip * nip + nip * npair)
                         * pair_amp.element_size(), pair_amp.device)


def _chi(pair_amp, delta, om):
    """chi(iw) for a block of frequencies: (nb, nip, nip)
    sum_p g_p A[:, p] conj(A[:, p])^T, g_p = -4 Delta_p / (Delta_p^2 +
    w^2): A g A^H, where the JAX package contracts A g A^T (see the
    module docstring)."""
    g = -4.0 * delta[None, :] / (delta * delta + om[:, None] * om[:, None])
    return (pair_amp[None] * g[:, None, :].to(pair_amp.dtype)) \
        @ pair_amp.mH


def _rpa_q(pair_amp, delta, wq, omega, weight, inv_nk):
    """Frequency-integrated ring energy of one momentum sector.

    pair_amp: (nip, npair) complex; delta: (npair,) positive; wq: (nip, nip);
    omega, weight: (nw,) real tensors.  Returns the 0-d real tensor
    sum_w weight * Re[ln det(1 - K) + tr K], K = inv_nk * wq @ chi."""
    nip = wq.shape[0]
    eye = torch.eye(nip, dtype=wq.dtype, device=wq.device)
    total = torch.zeros((), dtype=omega.dtype, device=wq.device)
    for blk in _freq_blocks(len(omega), pair_amp):
        k_mat = inv_nk * (wq @ _chi(pair_amp, delta, omega[blk]))
        sign, logdet = torch.linalg.slogdet(eye - k_mat)
        val = (logdet + torch.log(sign)) + torch.diagonal(
            k_mat, dim1=-2, dim2=-1).sum(-1)
        total = total + torch.sum(weight[blk] * val.real)
    return total


def _sector_pairs(df, xo, xv, mo_e, nocc, q):
    """(pair_amp (nip, nk*no*nv), delta (nk*no*nv,) on the device) of
    sector q: the pairs (i k_i, a k_a) with kconserv2[k_i, k_a] = q."""
    k2c = df.kconserv2()
    blocks, deltas = [], []
    for ki in range(df.nkpt):
        ka = int(np.nonzero(k2c[ki] == q)[0][0])
        blocks.append(_pair_mat(xo[ki], xv[ka]))
        deltas.append((mo_e[ka][nocc:][None, :]
                       - mo_e[ki][:nocc][:, None]).ravel())
    delta = torch.as_tensor(np.concatenate(deltas), dtype=df.rdtype,
                            device=df.x_k.device)
    return torch.cat(blocks, dim=1), delta


def drpa(df, mf, nw=24):
    """dRPA correlation energy per cell from a converged KRHF.

    df: built FFTISDF; mf: KRHF with mo_coeff/mo_energy/mo_occ.
    Returns (e_c, detail dict)."""
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    nocc = int(round(mo_o[0].sum() / 2))
    assert nocc > 0 and nocc < mo_c.shape[-1], "need occupied and virtuals"
    _, xo, xv = _mo_blocks(df, mo_c, nocc)
    omega, weight = _freq_grid(nw)
    dev, rdt = df.x_k.device, df.rdtype
    om_d = torch.as_tensor(omega, dtype=rdt, device=dev)
    wt_d = torch.as_tensor(weight, dtype=rdt, device=dev)
    e_c = torch.zeros((), dtype=rdt, device=dev)
    for q in range(nk):
        pair_amp, delta = _sector_pairs(df, xo, xv, mo_e, nocc, q)
        e_c = e_c + _rpa_q(pair_amp, delta, df.wq[q], om_d, wt_d, 1.0 / nk)
    e_c = float(e_c.item()) / (2.0 * np.pi * nk)
    return e_c, {"nw": nw, "nocc": nocc, "nk": nk}


def drpa_ov_space(v_iajb, eps_o, eps_v, nw=24):
    """Oracle: dRPA from explicit (ia|jb) integrals in the full ov pair
    space (gamma point / single sector), algebraically identical to the
    nip-space contraction (numpy)."""
    no, nv = len(eps_o), len(eps_v)
    nov = no * nv
    v = np.asarray(v_iajb).reshape(nov, nov)
    delta = (np.asarray(eps_v)[None, :]
             - np.asarray(eps_o)[:, None]).ravel()
    omega, weight = _freq_grid(nw)
    e_c = 0.0
    eye = np.eye(nov)
    for om, wt in zip(omega, weight):
        g = -4.0 * delta / (delta * delta + om * om)
        k_mat = v * g[None, :]
        sign, logdet = np.linalg.slogdet(eye - k_mat)
        val = logdet + np.log(sign) + np.trace(k_mat)
        e_c += wt * np.real(val)
    return e_c / (2.0 * np.pi)
