"""SCF numerics: DIIS/ADIIS extrapolation and occupations, on tensors.

Counterpart of ``fftisdf_tpu/scf/core.py``.  Each function is written once,
in torch, and serves both SCF loops: the device-resident loop
(``scf.device``) calls it on the card's tensors, the host loop (``scf.hf``)
on CPU tensors made from its numpy arrays by the wrappers at the end.
The two fixed-trip loops (the ADIIS descent, the chemical-potential
bisection) live in ``ops.scf_loops``: one kernel launch each on the card,
the plain loop of tensor ops on the CPU; neither waits for the device.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.ops import scf_loops


def _real_finfo(dtype):
    """finfo of the real dtype underlying a (possibly complex) dtype."""
    return torch.finfo(dtype.to_real())


def diis_extrapolate(errs, focks, valid):
    """Pulay-extrapolated Fock from stored (error, fock) rows.

    errs/focks: (m, L) complex rows; valid: (m,) bool mask of live slots."""
    return diis_coefficients(errs.conj() @ errs.T, valid) @ focks


def diis_coefficients(b, valid):
    """Pulay coefficients from the error Gram matrix b[i, j] = <err_i,
    err_j> (m, m) and the (m,) bool mask of live slots.

    Minimises |sum_i c_i err_i|^2 subject to sum_i c_i = 1, with B
    normalised by its largest live element and a relative Tikhonov term
    (well-posed from |err| ~ 1 to convergence; a scalar rescale of B does
    not move the constrained minimiser)."""
    m = b.shape[0]
    dt, dev = b.dtype, b.device
    vv = valid[:, None] & valid[None, :]
    scale = torch.where(vv, b.abs(), 0.0).max() + _real_finfo(dt).tiny
    b = torch.where(vv, b / scale, torch.eye(m, dtype=dt, device=dev))
    edge = torch.where(valid, -1.0, 0.0).to(dt)
    a = torch.cat([torch.cat([b, edge[:, None]], dim=1),
                   torch.cat([edge, torch.zeros(1, dtype=dt, device=dev)]
                             )[None, :]], dim=0)
    a = a + 1e-12 * torch.eye(m + 1, dtype=dt, device=dev)
    rhs = torch.cat([torch.zeros(m, dtype=dt, device=dev),
                     -torch.ones(1, dtype=dt, device=dev)])
    # solve_ex: no error check, so no wait on the device
    return torch.linalg.solve_ex(a, rhs)[0][:m] * valid.to(dt)


def adiis_coeffs(dms, focks, ref, valid, n_steps=400):
    """ADIIS simplex coefficients (Hu & Yang, JCP 132, 054109 (2010)).

    Minimises the quadratic energy model
        f(c) = 2 sum_i c_i Re<D_i - D_ref, F_ref>
             + sum_ij c_i c_j Re<D_i - D_ref, F_j - F_ref>
    over the simplex by entropic mirror descent (c <- c exp(-eta g),
    renormalised; ``ops.scf_loops.adiis_descent``): every iterate is
    feasible and dead slots are absorbing.  dms/focks: (m, L) flattened
    complex histories; ``ref`` the slot of the current (D, F); valid: (m,)
    bool.  Returns c (m,) real."""
    return scf_loops.adiis_descent(*adiis_model(dms, focks, ref, valid),
                                   n_steps)


def adiis_model(dms, focks, ref, valid):
    """The ADIIS model of :func:`adiis_coeffs`, scaled to a largest entry
    of order 1: ``(a, b + b^T, vf)``, with vf the 0/1 live-slot mask."""
    rdt = dms.real.dtype
    tiny = _real_finfo(rdt).tiny
    dd = dms - dms[ref][None, :]
    df = focks - focks[ref][None, :]
    vf = valid.to(rdt)
    # dead slots are zeroed before the scale: their rows would otherwise
    # blow up through a near-zero scale
    a = (dd.conj() @ focks[ref]).real * vf
    b = (dd.conj() @ df.T).real * vf[:, None] * vf[None, :]
    scale = a.abs().max() + b.abs().max() + tiny
    a = a / scale
    b = b / scale
    return a, b + b.T, vf


def smeared_occ(e, ok, nelec_target, sigma, method):
    """Fractional occupations from a bisected global chemical potential.

    e: eigenvalues, any shape; ok: same-shape bool (False: dropped or
    padded slot, occupation exactly 0); ``sum(f)`` is bisected to
    ``nelec_target`` in 90 steps (``ops.scf_loops.smeared_bisect``).
    Returns ``(f, entropy, mu)`` as tensors, with the dimensionless entropy
    S of the Mermin free energy E - sigma S."""
    f, s, mu = scf_loops.smeared_bisect(e[None], ok[None], (nelec_target,),
                                        sigma, method)
    return f[0], s[0], mu[0]


def aufbau_occ(e, ok, nocc):
    """0/1 occupations of the ``nocc`` lowest valid states per k row;
    e, ok: (nk, nmo).  Invalid slots never occupy."""
    ee = torch.where(ok, e, 1e30)
    rank = torch.argsort(torch.argsort(ee, dim=-1, stable=True), dim=-1,
                         stable=True)
    return ((rank < nocc) & ok).to(e.dtype)


# ----------------------------------------------------------------------
# Host wrappers over ragged per-k spectra (lists of 1-D numpy arrays of
# possibly differing lengths after canonical orthogonalisation).

def smeared_occupations(es, nocc, sigma, method="fermi", factor=2.0):
    """Occupations from a global chemical potential over ragged per-k
    spectra ``es``: ``(occs, mu, entropy)`` with sum == factor nocc nk."""
    ns = [len(np.asarray(ek)) for ek in es]
    e = np.full((len(es), max(ns)), 1e30)
    ok = np.zeros((len(es), max(ns)), dtype=bool)
    for i, ek in enumerate(es):
        e[i, :ns[i]] = np.asarray(ek)
        ok[i, :ns[i]] = True
    f, s, mu = smeared_occ(torch.from_numpy(e), torch.from_numpy(ok),
                           float(nocc * len(es)), sigma, method)
    f = f.numpy()
    occs = [factor * f[i, :n] for i, n in enumerate(ns)]
    return occs, float(mu), factor * float(s)


def fixed_occupations(es, nocc, factor=2.0):
    """Aufbau 0/factor occupations per k row (ragged input)."""
    out = []
    for ek in es:
        occ = np.zeros(len(np.asarray(ek)))
        occ[:nocc] = factor
        out.append(occ)
    return out
