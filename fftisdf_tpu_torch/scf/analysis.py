"""Mulliken populations of a converged k-point SCF state (host numpy).

Counterpart of the Mulliken part of ``fftisdf_tpu/scf/analysis.py``: the
local spin moments are the observable of the NiO AFM slice.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.basis import data as basis_data


def atom_charges_and_moments(cell, dm, s1e):
    """Per-atom (charges, spin moments) from Re diag(D S), k-averaged.

    ``dm`` is (nk, nao, nao) restricted or (2, nk, nao, nao); charge =
    Z_eff - n_atom, moment = n_alpha - n_beta (zero for restricted)."""
    dm = np.asarray(dm)
    s1e = np.asarray(s1e)
    dms = dm if dm.ndim == 4 else dm[None]
    pop = np.einsum("skmn,knm->sm", dms, s1e).real / s1e.shape[0]
    charges, moments = [], []
    off = 0
    for sym, _ in cell.atom:
        nfa = sum(sh.nfunc for sh in cell._basis[sym])
        n_s = pop[:, off:off + nfa].sum(axis=1)
        off += nfa
        ps = cell._pseudo.get(sym)
        z = (float(ps.zion) if ps is not None else float(
            basis_data.ATOMIC_NUMBER[basis_data.element_symbol(sym)]))
        charges.append(z - n_s.sum())
        moments.append(n_s[0] - n_s[1] if dm.ndim == 4 else 0.0)
    return np.asarray(charges), np.asarray(moments)
