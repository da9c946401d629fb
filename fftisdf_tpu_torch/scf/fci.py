"""Exact diagonalisation (FCI) for small orbital spaces.

Counterpart of ``fftisdf_tpu/scf/fci.py``: the determinant-basis solver
restricted to the (n_alpha, n_beta) particle sector, the impurity solver of
:mod:`fftisdf_tpu_torch.scf.dmet` and an oracle for the tests.  Spatial
orbitals with complex Hermitian one-body ``h1`` and chemists' ``(pq|rs)``
two-body integrals:

    H = sum_pq h1[p,q] sum_s  p+_s q_s
      + 1/2 sum_pqrs (pq|rs) sum_st p+_s r+_t s_t q_s

Determinants are int64 occupation bit strings (alpha modes 0..n-1, beta
modes n..2n-1); fermionic operator strings act on them with torch's
bitwise ops and the exact parity signs.  The Hamiltonian's operator
strings (one- and two-body, both spin pairings) are applied to the whole
sector in batches on the device (memory blocks of the strings), the
sector Hamiltonian is accumulated there and diagonalised by
``torch.linalg.eigh``; the RDMs are read the same way.  Up to ``_MAX_ORB`` = 8 spatial orbitals (C(8,4)^2 =
4900 determinants at half filling).

Returns the ground-state electronic energy with spin-summed RDMs in the
conventions

    gamma[p,q]   = <p+ q>            E1 = sum h1[p,q] gamma[p,q]
    Gamma[pqrs]  = <p+ r+ s q>       E2 = 1/2 sum (pq|rs) Gamma[pqrs]

and asserts that the energy rebuilt from (gamma, Gamma) equals the
eigenvalue, the built-in check of those conventions.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from fftisdf_tpu_torch.utils.device import (memory_blocks, resolve_device,
                                            to_numpy)

_MAX_ORB = 8
_DROP = 1e-14          # integrals at or below this magnitude are skipped


def _popcount64(x):
    """Popcount of a non-negative int64 tensor, elementwise."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _apply_string_vec(ops, states):
    """Apply a right-to-left string of (mode, create) to int64 states.

    A mode is an int64 tensor that broadcasts against ``states`` (one
    operator string per row); returns (new_states, sign (+-1), valid
    mask) of the broadcast shape."""
    st = states.clone()
    sign = torch.ones_like(states)
    valid = torch.ones_like(states, dtype=torch.bool)
    for mode, create in reversed(ops):
        bit = torch.ones_like(mode) << mode
        occupied = (st & bit) != 0
        valid = valid & (~occupied if create else occupied)
        parity = _popcount64(st & (bit - 1)) & 1
        sign = torch.where(parity == 1, -sign, sign)
        st = st ^ bit
    return st, sign, valid


def _sector_basis(n, na, nb):
    """Bitmask basis: alpha modes 0..n-1, beta modes n..2n-1."""
    states = []
    for occ_a in combinations(range(n), na):
        ma = sum(1 << p for p in occ_a)
        for occ_b in combinations(range(n), nb):
            states.append(ma | sum(1 << (n + p) for p in occ_b))
    return states


def _strings(n, h1=None, eri=None):
    """The Hamiltonian's operator strings as [(modes (nops, L), values)]:
    the one-body p+ q (L = 2) and the two-body p+ r+ s q (L = 4) of both
    spin pairings, in loop order; without integrals, every string (the
    RDM elements) with no values, else those whose integral exceeds
    ``_DROP`` in magnitude."""
    ar = np.arange(n)
    p, q = (a.ravel() for a in np.meshgrid(ar, ar, indexing="ij"))
    keep = np.ones(p.shape, bool) if h1 is None else np.abs(h1[p, q]) > _DROP
    one = np.concatenate([np.stack([p[keep] + sp, q[keep] + sp], 1)
                          for sp in (0, n)])
    v1 = None if h1 is None else np.tile(h1[p, q][keep], 2)
    p, q, r, s = (a.ravel() for a in np.meshgrid(ar, ar, ar, ar,
                                                 indexing="ij"))
    keep = (np.ones(p.shape, bool) if eri is None
            else np.abs(eri[p, q, r, s]) > _DROP)
    two = np.concatenate([np.stack([p[keep] + s1, r[keep] + s2,
                                    s[keep] + s2, q[keep] + s1], 1)
                          for s1 in (0, n) for s2 in (0, n)])
    v2 = None if eri is None else np.tile(0.5 * eri[p, q, r, s][keep], 4)
    return [(one, v1), (two, v2)]


def _apply_strings(modes, states):
    """(new states, sign, valid) of each string of ``modes`` (nops, L),
    creators then annihilators as in p+ q or p+ r+ s q, applied to every
    state: (nops, ndet) each."""
    L = modes.shape[1]
    ops = [(modes[:, j:j + 1], j < L // 2) for j in range(L)]
    return _apply_string_vec(ops, states[None, :].expand(modes.shape[0], -1))


def fci_ground(h1, eri, nelec, device="cuda"):
    """Ground state in the (na, nb) sector.

    h1: (n, n) complex Hermitian; eri: (n, n, n, n) chemists' (pq|rs);
    nelec: total electron count (na = ceil, nb = floor) or (na, nb).
    Returns (e_elec, gamma, Gamma) with gamma and Gamma numpy arrays.
    """
    dev = resolve_device(device)
    h1 = np.asarray(to_numpy(h1), dtype=complex)
    eri = np.asarray(to_numpy(eri), dtype=complex)
    n = h1.shape[0]
    if n > _MAX_ORB:
        raise NotImplementedError(
            f"determinant FCI here is limited to {_MAX_ORB} spatial "
            f"orbitals (got {n}); use a smaller DMET fragment")
    if isinstance(nelec, (tuple, list)):
        na, nb = int(nelec[0]), int(nelec[1])
    else:
        nb = int(nelec) // 2
        na = int(nelec) - nb
    states = torch.as_tensor(_sector_basis(n, na, nb), dtype=torch.int64,
                             device=dev)
    dim = states.shape[0]
    sorted_states, order = torch.sort(states)
    # the per-string temporaries: ~12 int64/bool planes of the sector
    per_op = 96 * dim

    def rows_of(st2, ok):
        pos = torch.searchsorted(sorted_states, st2).clamp(max=dim - 1)
        # spin-sector conservation guarantees membership; verify anyway
        assert bool(torch.where(ok, sorted_states[pos] == st2, True).all())
        return order[pos]

    cols = torch.arange(dim, device=dev)
    H = torch.zeros(dim * dim, dtype=torch.complex128, device=dev)
    for modes, vals in _strings(n, h1, eri):
        modes = torch.as_tensor(modes, dtype=torch.int64, device=dev)
        vals = torch.as_tensor(vals, dtype=torch.complex128, device=dev)
        for blk in memory_blocks(modes.shape[0], per_op, dev):
            st2, sg, ok = _apply_strings(modes[blk], states)
            flat = rows_of(st2, ok) * dim + cols[None, :]
            v = torch.where(ok, vals[blk, None] * sg, 0.0)
            H.index_put_((flat.ravel(),), v.ravel(), accumulate=True)
    w, vecs = torch.linalg.eigh(H.reshape(dim, dim))
    e0 = float(w[0])
    v = vecs[:, 0]

    # every RDM element <p+ q> and <p+ r+ s q>, spin pairings summed
    ev = []
    for modes, _ in _strings(n):
        modes = torch.as_tensor(modes, dtype=torch.int64, device=dev)
        out = torch.empty(modes.shape[0], dtype=torch.complex128,
                          device=dev)
        for blk in memory_blocks(modes.shape[0], per_op, dev):
            st2, sg, ok = _apply_strings(modes[blk], states)
            terms = v[rows_of(st2, ok)].conj() * sg * v[None, :]
            out[blk] = torch.where(ok, terms, 0.0).sum(1)
        ev.append(to_numpy(out))
    gamma = ev[0].reshape(2, n, n).sum(0)
    Gam = ev[1].reshape(4, n, n, n, n).sum(0)
    e_check = (np.einsum("pq,pq->", h1, gamma)
               + 0.5 * np.einsum("pqrs,pqrs->", eri, Gam))
    assert abs(e_check - e0) < 1e-8 * max(1.0, abs(e0)), (e_check, e0)
    return e0, gamma, Gam
