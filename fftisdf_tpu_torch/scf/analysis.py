"""Population analysis of converged k-point SCF states (host numpy).

Counterpart of ``fftisdf_tpu/scf/analysis.py``: Mulliken (Re diag(D S))
and Loewdin (diag(S^1/2 D S^1/2)) populations, k-averaged and resolved
per atom, the local spin moments and charge transfer of the NiO AFM
slice.
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.basis import data as basis_data


def _atom_offsets(cell):
    """[(symbol, offset, nfunc), ...] in the package AO layout."""
    out = []
    off = 0
    for sym, _ in cell.atom:
        nfa = sum(sh.nfunc for sh in cell._basis[sym])
        out.append((sym, off, nfa))
        off += nfa
    return out


def ao_populations(cell, dm, s1e, scheme="mulliken"):
    """Per-AO populations (nspin, nao), k-averaged.

    ``dm`` is (nk, nao, nao) restricted (one channel holding the total
    population) or (2, nk, nao, nao).  ``scheme``: 'mulliken'
    (Re diag(D S)) or 'loewdin' (diag(S^1/2 D S^1/2), stable under basis
    rotations: the projector frame of the DFT+U occupations,
    ``scf.hubbard``)."""
    dm = np.asarray(dm)
    s1e = np.asarray(s1e)
    dms = dm if dm.ndim == 4 else dm[None]
    nk = s1e.shape[0]
    if scheme == "mulliken":
        return np.einsum("skmn,knm->sm", dms, s1e).real / nk
    if scheme == "loewdin":
        from fftisdf_tpu_torch.scf.hubbard import shalf_kpts

        sh = shalf_kpts(s1e)
        return np.einsum("kpm,skmn,knp->sp", sh, dms, sh).real / nk
    raise ValueError(f"unknown population scheme {scheme!r}")


def atom_charges_and_moments(cell, dm, s1e, scheme="mulliken"):
    """Per-atom (charges, spin moments) from a converged density.

    charge = Z_eff - n_atom (Z_eff from the pseudopotential when present),
    moment = n_alpha - n_beta (zero for restricted input); two (natm,)
    arrays aligned with ``cell.atom``."""
    pop = ao_populations(cell, dm, s1e, scheme=scheme)
    spin_resolved = pop.shape[0] == 2
    charges, moments = [], []
    for sym, off, nfa in _atom_offsets(cell):
        n_s = pop[:, off:off + nfa].sum(axis=1)
        ps = cell._pseudo.get(sym)
        z = (float(ps.zion) if ps is not None else float(
            basis_data.ATOMIC_NUMBER[basis_data.element_symbol(sym)]))
        charges.append(z - n_s.sum())
        moments.append(n_s[0] - n_s[1] if spin_resolved else 0.0)
    return np.asarray(charges), np.asarray(moments)


def mulliken(mf, scheme="mulliken", log=True):
    """Population analysis of a converged SCF driver: (charges (natm,),
    moments (natm,)), printed per atom when ``log``."""
    if getattr(mf, "dm", None) is None:
        raise ValueError("run mf.kernel() first")
    charges, moments = atom_charges_and_moments(mf.cell, mf.dm, mf.s1e,
                                                scheme=scheme)
    if log:
        print(f"{scheme} analysis:")
        for (sym, _), q, m in zip(mf.cell.atom, charges, moments):
            print(f"  {sym:4s} charge {q:+.4f}  moment {m:+.4f}")
    return charges, moments
