"""k-point MP2 on top of the ISDF ERI factorisation.

Counterpart of ``fftisdf_tpu/scf/mp2.py``: restricted (``kmp2``) and
unrestricted (``kump2``) MP2 from converged KRHF/KUHF (or KRKS/KUKS)
orbitals, insulating occupations,

    E2 = (1/nk^3) sum_{k_i k_a k_j} sum_{iajb}
         t_iajb (2 conj(v_iajb) - conj(v_ibja)),   t = v / D,

with v_{iajb} = (i k_i, a k_a | j k_j, b k_b) = t12^T (w_q t34), k_b fixed
by momentum conservation, exactly as ``isdf.eri.assemble_eri`` assembles
it.  The JAX package loops over the nk^3 triples in Python with two
assemblies each; here the sum is organised by momentum sector:

- for a sector q every pair (k_j, k_b) that conserves momentum with a pair
  of sector q is stacked into one (nip, nk * no * nv) block, and
  ``U_q = w_q @ T34_q`` is formed once per q (the JAX package forms it once
  per triple);
- for each k_i, ``V[q] = t12(k_i, k_a(q))^T @ U_q`` gives every
  (k_a, k_j) block of that row in one batched product, and the exchange
  partner v_ibja of the triple (k_i, k_a, k_j) is the block (k_i, k_b, k_j)
  of the same row read with its virtual indices swapped.

Each triple's arithmetic (t = v / D, the pairing of v_iajb with v_ibja,
the denominators) is the JAX package's; only the order of the sum and the
batching of the products differ, which changes the energy at roundoff.
One scalar per k_i row is accumulated on the device and the energy is
fetched once.  Tensors stay on the device of the ISDF state.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.isdf.eri import pair_vectors as _pair_mat
from fftisdf_tpu_torch.utils.device import as_tensor


def _sector_maps(df):
    """(k2c, ka_of (nk_i, nq), kb_of (nq, nk_j)): ka_of[ki, q] is the k_a
    with k2c[ki, k_a] = q, kb_of[q, kj] the k_b that conserves momentum
    with a pair of sector q and k_j (the same for every pair of q)."""
    k2c = np.asarray(df.kconserv2())
    k3c = np.asarray(df.kconserv3())
    nk = k2c.shape[0]
    ka_of = np.argsort(k2c, axis=1)
    assert np.array_equal(np.take_along_axis(k2c, ka_of, 1),
                          np.broadcast_to(np.arange(nk), (nk, nk))), \
        "k-mesh not closed under the sector shifts"
    kb_of = np.stack([k3c[0, ka_of[0, q]] for q in range(nk)])
    for ki in range(1, nk):
        assert np.array_equal(k3c[ki, ka_of[ki]], kb_of)
    return k2c, ka_of, kb_of


def _sector_products(wq, xo, xv, kb_of):
    """U (nq, nip, nk * no * nv): U_q = w_q @ [t34(k_j, kb_of[q, k_j])]_kj."""
    nq, nip = wq.shape[0], wq.shape[1]
    out = []
    for q in range(nq):
        t34 = _pair_mat(xo, xv[torch.as_tensor(kb_of[q], device=xv.device)])
        nk, _, nov = t34.shape
        t34 = t34.permute(1, 0, 2).reshape(nip, nk * nov)
        out.append(wq[q] @ t34)
    return torch.stack(out)


def _row_blocks(u, xo_i, xv, ka_of_i, no1, nv1, no2, nv2):
    """V (nq, no1, nv1, nk_j, no2, nv2) of one k_i row: block q holds
    (i k_i, a ka_of_i[q] | j k_j, b kb_of[q, k_j]) for every k_j."""
    t12 = _pair_mat(xo_i[None], xv[torch.as_tensor(ka_of_i,
                                                   device=xv.device)])
    v = t12.mT @ u                                   # (nq, ov1, nk*ov2)
    return v.reshape(v.shape[0], no1, nv1, xv.shape[0], no2, nv2)


def _denominators(eo1_i, ev1, eo2, ev2, ka_of_i, kb_of):
    """D (nq, no1, nv1, nk_j, no2, nv2) = e_i + e_j - e_a - e_b."""
    ea = ev1[ka_of_i]                                # (nq, nv1)
    eb = ev2[kb_of]                                  # (nq, nk, nv2)
    return (eo1_i[None, :, None, None, None, None]
            - ea[:, None, :, None, None, None]
            + eo2[None, None, None, :, :, None]
            - eb[:, None, None, :, None, :])


def _exchange_blocks(v, k2c_i, kb_of):
    """v_ibja aligned to (q, i, a, k_j, j, b): the block of sector
    k2c_i[kb_of[q, kj]] (the pair (k_i, k_b)) at k_j, virtuals swapped."""
    nq, nk = kb_of.shape
    qb = torch.as_tensor(k2c_i[kb_of], device=v.device)        # (nq, nk)
    kj = torch.arange(nk, device=v.device)[None, :].expand(nq, nk)
    vx = v.permute(0, 3, 1, 2, 4, 5)[qb, kj]        # (nq, nk, i, b, j, a)
    return vx.permute(0, 2, 5, 1, 4, 3)             # (nq, i, a, nk, j, b)


def _mo_blocks(df, mo_c, nocc):
    """MO-projected interpolation vectors x_k C_k (nk, nip, nmo) and their
    occupied and virtual column blocks."""
    x = df.x_k
    xm = x @ as_tensor(np.asarray(mo_c).astype(np.complex128), x.device,
                       x.dtype)
    return xm, xm[..., :nocc], xm[..., nocc:]


def kmp2(df, mf):
    """MP2 correlation energy per cell from a converged KRHF ``mf``.

    df: built FFTISDF; mf: KRHF with mo_coeff/mo_energy/mo_occ set.
    Returns (e_mp2, detail dict)."""
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)      # (nk, nao, nmo)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    nocc = int(round(mo_o[0].sum() / 2))
    k2c, ka_of, kb_of = _sector_maps(df)
    _, xo, xv = _mo_blocks(df, mo_c, nocc)
    dev, rdt = df.x_k.device, df.rdtype
    eo = torch.as_tensor(mo_e[:, :nocc], dtype=rdt, device=dev)
    ev = torch.as_tensor(mo_e[:, nocc:], dtype=rdt, device=dev)
    no, nv = nocc, mo_c.shape[-1] - nocc
    u = _sector_products(df.wq, xo, xv, kb_of)
    e2 = torch.zeros((), dtype=df.cdtype, device=dev)
    for ki in range(nk):
        v = _row_blocks(u, xo[ki], xv, ka_of[ki], no, nv, no, nv)
        vx = _exchange_blocks(v, k2c[ki], kb_of)
        d = _denominators(eo[ki], ev, eo, ev, ka_of[ki], kb_of)
        t = v / d
        e2 = e2 + torch.sum(t * (2.0 * v.conj() - vx.conj()))
        del v, vx, d, t
    # per-cell normalisation: supercell orbitals are Bloch/sqrt(nk), so
    # each cell-integrated v carries 1/nk against the supercell ERI and
    # the triple k-sum has nk^3 terms (the JAX package's k-mesh vs
    # doubled-supercell consistency test pins it)
    e2 = complex(e2.item()) / nk ** 3
    return float(np.real(e2)), {"imag": float(np.imag(e2)), "nocc": nocc}


def kump2(df, mf):
    """Unrestricted k-point MP2 from a converged KUHF/KUKS ``mf``: the
    correlated method for the spin-polarised north-star system (NiO AFM).

        E2 = E_ss(alpha) + E_ss(beta) + E_os
        E_ss^s = (1/2) sum t (v_iajb - v_ibja)^*,  t = v_iajb / D
        E_os   =       sum t v_iajb^*   (i,a alpha; j,b beta: each
                                         opposite-spin pair counted once)

    with the ISDF ERI assembly and 1/nk^3 per-cell normalisation of
    :func:`kmp2`; it reduces exactly to it for closed shells.  The detail
    dict also carries the three parts (``e_ss`` per spin, ``e_os``)."""
    nk = df.nkpt
    mo_c = np.asarray(mf.mo_coeff)      # (2, nk, nao, nmo)
    mo_e = np.asarray(mf.mo_energy)
    mo_o = np.asarray(mf.mo_occ)
    assert mo_c.ndim == 4, "kump2 needs a spin-resolved (KUHF/KUKS) mf"
    noccs = [int(round(mo_o[s][0].sum())) for s in range(2)]
    nmo = mo_c.shape[-1]
    k2c, ka_of, kb_of = _sector_maps(df)
    dev, rdt = df.x_k.device, df.rdtype
    xo, xv, eo, ev, u = [], [], [], [], []
    for s in range(2):
        _, a, b = _mo_blocks(df, mo_c[s], noccs[s])
        xo.append(a)
        xv.append(b)
        eo.append(torch.as_tensor(mo_e[s][:, :noccs[s]], dtype=rdt,
                                  device=dev))
        ev.append(torch.as_tensor(mo_e[s][:, noccs[s]:], dtype=rdt,
                                  device=dev))
        u.append(_sector_products(df.wq, a, b, kb_of))
    parts = []
    for s1, s2 in ((0, 0), (1, 1), (0, 1)):
        n1, n2 = noccs[s1], noccs[s2]
        acc = torch.zeros((), dtype=df.cdtype, device=dev)
        for ki in range(nk):
            v = _row_blocks(u[s2], xo[s1][ki], xv[s1], ka_of[ki], n1,
                            nmo - n1, n2, nmo - n2)
            d = _denominators(eo[s1][ki], ev[s1], eo[s2], ev[s2],
                              ka_of[ki], kb_of)
            t = v / d
            if s1 == s2:
                vx = _exchange_blocks(v, k2c[ki], kb_of)
                acc = acc + 0.5 * torch.sum(t * (v.conj() - vx.conj()))
                del vx
            else:
                acc = acc + torch.sum(t * v.conj())
            del v, d, t
        parts.append(complex(acc.item()) / nk ** 3)
    e2 = sum(parts)
    return float(np.real(e2)), {
        "imag": float(np.imag(e2)), "nocc": tuple(noccs),
        "e_ss": (float(parts[0].real), float(parts[1].real)),
        "e_os": float(parts[2].real)}
