"""Density of states from converged k-point SCF states (host numpy).

Counterpart of ``fftisdf_tpu/scf/dos.py``: total DOS, Loewdin-projected
DOS (per AO or per atom) and integrated DOS from the band energies of any
driver of ``scf.hf`` / ``scf.ks``.  The data are (nk, nao) small, so this
is float64 numpy on the host, as ``scf.analysis`` is.

Conventions: energies in Hartree; DOS in states per Hartree per cell,
counting spin (a restricted run carries a factor 2, an unrestricted one
returns its two channels apart), so the integral over all E is 2*nao
(restricted) or nao (a spin channel).
"""
from __future__ import annotations

import numpy as np

from fftisdf_tpu_torch.scf.analysis import _atom_offsets
from fftisdf_tpu_torch.scf.hubbard import shalf_kpts


def _as_band_list(mo_energy):
    """(nk, nmo) arrays or ragged per-k lists -> list of 1D arrays."""
    if isinstance(mo_energy, np.ndarray) and mo_energy.ndim == 2:
        return [np.asarray(e, dtype=float) for e in mo_energy]
    return [np.asarray(e, dtype=float).ravel() for e in mo_energy]


def _broaden(de, sigma, kind):
    """Normalised broadening kernel g(de): its integral over de is 1."""
    if kind == "gaussian":
        return np.exp(-(de / sigma) ** 2 / 2) / (sigma * np.sqrt(2 * np.pi))
    if kind == "lorentzian":
        return (sigma / np.pi) / (de * de + sigma * sigma)
    raise ValueError(f"unknown broadening kind {kind!r}")


def dos_from_bands(mo_energy, energies, sigma=0.02, weights=None,
                   kind="gaussian", degeneracy=1.0):
    """DOS on an energy grid from per-k band energies.

    mo_energy: (nk, nmo) array or ragged list of 1D arrays; weights:
    optional per-state weights, weights[k] of shape (..., nmo_k) with the
    band axis last; degeneracy: the spin multiplicity folded in (2 for
    restricted).  Returns (npts,), or (ncomp, npts) when the weights carry
    a component axis."""
    es = _as_band_list(mo_energy)
    energies = np.asarray(energies, dtype=float)
    out = None
    for k, ek in enumerate(es):
        g = _broaden(energies[:, None] - ek[None, :], sigma, kind)
        if weights is None:
            acc = g.sum(axis=1)
        else:
            acc = np.einsum("...n,en->...e",
                            np.asarray(weights[k], dtype=float), g)
        out = acc if out is None else out + acc
    return out * (degeneracy / len(es))


def _loewdin_weights(mo_coeff, s1e):
    """Per-k Loewdin AO weights w[k] (nao, nmo_k): |S^1/2 C|^2 columns.
    Each band's weights sum to 1 over the AOs (C^H S C = 1), so the
    projected DOS sums to the total DOS identically."""
    sh = shalf_kpts(np.asarray(s1e))
    return [np.abs(sh[k] @ np.asarray(mo_coeff[k])) ** 2
            for k in range(len(sh))]


def _spin_channels(mf):
    """[(mo_energy list, mo_coeff list, label), ...] per spin channel."""
    es = mf.mo_energy
    cs = mf.mo_coeff
    if np.asarray(es[0]).ndim == 2 or (isinstance(es, np.ndarray)
                                       and es.ndim == 3):
        return [(es[0], cs[0], "alpha"), (es[1], cs[1], "beta")]
    return [(es, cs, None)]


def fermi_level(mf):
    """Chemical potential of a converged driver: the smeared mu when
    present, else the HOMO/LUMO midpoint over the k-mesh."""
    mu = getattr(mf, "mu", None)
    if mu is not None:
        return float(np.mean(mu)) if np.ndim(mu) else float(mu)
    occs = (mf.mo_occ if np.asarray(mf.mo_occ[0]).ndim == 2
            else [mf.mo_occ])
    e = np.concatenate([np.concatenate(_as_band_list(c[0]))
                        for c in _spin_channels(mf)])
    o = np.concatenate([np.concatenate([np.asarray(x, float).ravel()
                                        for x in occ]) for occ in occs])
    homo = e[o > 1e-6].max()
    lumo_cands = e[o <= 1e-6]
    return (float((homo + lumo_cands.min()) / 2) if lumo_cands.size
            else float(homo))


def _require_bands(mf):
    if getattr(mf, "mo_energy", None) is None:
        raise ValueError("run mf.kernel() first")


def density_of_states(mf, energies=None, sigma=0.02, npts=600,
                      kind="gaussian", window=None):
    """Total DOS of a converged driver: (energies (npts,), dos) with dos
    (npts,) restricted or (2, npts) unrestricted.  ``window``: (emin,
    emax) in Hartree; the default spans the bands padded by 5 sigma."""
    _require_bands(mf)
    channels = _spin_channels(mf)
    if energies is None:
        all_e = np.concatenate([np.concatenate(_as_band_list(e))
                                for e, _, _ in channels])
        lo, hi = window if window is not None else (
            all_e.min() - 5 * sigma, all_e.max() + 5 * sigma)
        energies = np.linspace(lo, hi, npts)
    deg = 2.0 if len(channels) == 1 else 1.0
    dos = [dos_from_bands(e, energies, sigma=sigma, kind=kind,
                          degeneracy=deg) for e, _, _ in channels]
    return energies, (dos[0] if len(dos) == 1 else np.stack(dos))


def projected_dos(mf, energies=None, sigma=0.02, npts=600, kind="gaussian",
                  groupby="atom", window=None):
    """Loewdin-projected DOS on the SCF k-mesh: (energies, pdos) with pdos
    (natm, npts) for groupby 'atom' or (nao, npts) for 'ao', behind a
    spin axis for unrestricted drivers.  Summed over its group axis it is
    :func:`density_of_states` (Loewdin weights resolve the identity band
    by band)."""
    _require_bands(mf)
    channels = _spin_channels(mf)
    if energies is None:
        energies, _ = density_of_states(mf, sigma=sigma, npts=npts,
                                        kind=kind, window=window)
    deg = 2.0 if len(channels) == 1 else 1.0
    outs = []
    for e_ch, c_ch, _ in channels:
        w = _loewdin_weights(c_ch, mf.s1e)
        if groupby == "atom":
            offs = _atom_offsets(mf.cell)
            w = [np.stack([wk[o:o + n].sum(axis=0) for _, o, n in offs])
                 for wk in w]
        elif groupby != "ao":
            raise ValueError(f"unknown groupby {groupby!r}")
        outs.append(dos_from_bands(e_ch, energies, sigma=sigma, kind=kind,
                                   weights=w, degeneracy=deg))
    return energies, (outs[0] if len(outs) == 1 else np.stack(outs))


def integrated_dos(energies, dos, e_max):
    """States below e_max: the trapezoidal integral of the (possibly
    spin-stacked) DOS up to e_max."""
    energies = np.asarray(energies)
    dos = np.asarray(dos)
    m = energies <= e_max
    return np.trapezoid(dos[..., m], energies[m], axis=-1)
