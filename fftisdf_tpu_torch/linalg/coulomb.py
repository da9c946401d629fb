"""Reciprocal-space Coulomb kernels: bare, range-separated and truncated.

Counterpart of ``fftisdf_tpu/linalg/coulomb.py``.  The 3D periodic kernel
with ``exxdiv=None``,

    coulG(q)[G] = 4 pi / |q + G|^2,    coulG = 0 where |q + G| = 0,

drops its divergent q+G = 0 sample (the G = 0 Hartree term cancels against
the neutralising background).

Range separation (``omega``), in PySCF's sign convention:

    omega = 0    full kernel            4 pi / |q+G|^2
    omega > 0    long-range  (erf)      4 pi exp(-|q+G|^2/(4 omega^2)) / |q+G|^2
    omega < 0    short-range (erfc)     4 pi (1 - exp(-|q+G|^2/(4 omega^2))) / |q+G|^2

The long-range kernel keeps the 1/|q+G|^2 divergence, so its q+G = 0 sample
is dropped like the full kernel's.  The short-range kernel is finite there,
with the limit pi/omega^2, which is kept.

Truncated kernels (``trunc``) remove the coupling to periodic images along
non-periodic directions:

    trunc = ("0d", rc)   spherical truncation (Spencer-Alavi 2008; Rozzi et
                         al. 2006): v(r) = 1/r for r < rc, else 0

        v(G) = 4 pi (1 - cos(|G| rc)) / |G|^2,     v(0) = 2 pi rc^2

    trunc = ("2d", rc)   slab truncation along the third lattice vector
                         (Ismail-Beigi, PRB 73, 233103 (2006)):
                         v(r) = 1/r for |z| < rc, else 0, rc = Lz/2

        Gp = |G_xy|, Gz = G_z:
        v(G)          = 4 pi / G^2 [1 + e^{-Gp rc}((Gz/Gp) sin(Gz rc)
                                                   - cos(Gz rc))]   (Gp > 0)
        v(Gp=0, Gz)   = 4 pi / Gz^2 [1 - cos(Gz rc) - Gz rc sin(Gz rc)]
        v(0)          = -2 pi rc^2

Both truncated kernels are even in q+G, so the build's time-reversal
halving w_{-q} = conj(w_q) still holds.  Their q+G = 0 value is finite and
kept.  Truncation composes with omega = 0 only (:func:`check_trunc`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fftisdf_tpu_torch.utils.device import real_complex, resolve_device


def _screen(absg2, omega):
    """Gaussian screening factor exp(-|q+G|^2 / (4 omega^2))."""
    return torch.exp(-absg2 / (4.0 * omega * omega))


def _coulG_values(absg2, omega):
    """Kernel values from |q+G|^2 (``omega`` is a python float)."""
    ok = absg2 > 1e-12
    one, zero = torch.ones_like(absg2), torch.zeros_like(absg2)
    inv = torch.where(ok, 4.0 * math.pi / torch.where(ok, absg2, one), zero)
    if not omega:
        return inv
    if omega > 0:          # long-range (erf): divergent q+G=0 dropped too
        return inv * _screen(absg2, omega)
    # short-range (erfc): finite pi/omega^2 limit at q+G=0
    return torch.where(ok, inv * (1.0 - _screen(absg2, omega)),
                       math.pi / (omega * omega) * one)


def _coulG_trunc_0d(gk, rc):
    """Spherical truncation from the full q+G vectors (..., ng, 3)."""
    absg2 = (gk * gk).sum(dim=-1)
    ok = absg2 > 1e-12
    safe = torch.where(ok, absg2, torch.ones_like(absg2))
    v = 4.0 * math.pi * (1.0 - torch.cos(torch.sqrt(safe) * rc)) / safe
    return torch.where(ok, v, 2.0 * math.pi * rc * rc * torch.ones_like(v))


def _coulG_trunc_2d(gk, rc):
    """Ismail-Beigi slab truncation (non-periodic axis: cartesian z of the
    third lattice vector) from q+G vectors (..., ng, 3)."""
    gz = gk[..., 2]
    gp2 = gk[..., 0] ** 2 + gk[..., 1] ** 2
    absg2 = gp2 + gz * gz
    one = torch.ones_like(absg2)
    pok = gp2 > 1e-12
    zok = gz * gz > 1e-12
    gp = torch.sqrt(torch.where(pok, gp2, one))
    # Gp > 0 branch (any Gz)
    vp = (4.0 * math.pi / torch.where(pok, absg2, one)
          * (1.0 + torch.exp(-gp * rc)
             * ((gz / gp) * torch.sin(gz * rc) - torch.cos(gz * rc))))
    # Gp = 0, Gz != 0 branch
    gz2 = torch.where(zok, gz * gz, one)
    vz = (4.0 * math.pi / gz2
          * (1.0 - torch.cos(gz * rc) - gz * rc * torch.sin(gz * rc)))
    v0 = -2.0 * math.pi * rc * rc * one
    return torch.where(pok, vp, torch.where(zok, vz, v0))


def _coulG_vec(gk, omega=0.0, trunc=None):
    """Kernel values from the full q+G vectors (..., ng, 3).  ``trunc`` is
    None or a ("0d"|"2d", rc) pair; truncation composes with omega = 0 only
    (guarded at the callers)."""
    if trunc is None:
        return _coulG_values((gk * gk).sum(dim=-1), omega)
    kind, rc = trunc
    if kind == "0d":
        return _coulG_trunc_0d(gk, float(rc))
    if kind == "2d":
        return _coulG_trunc_2d(gk, float(rc))
    raise ValueError(f"unknown truncation {kind!r} (use '0d' or '2d')")


def check_trunc(trunc, omega=0.0):
    """Validate a ``trunc`` spec (None or ('0d'|'2d', rc)); returns a
    normalised tuple or None.  Raises on omega with truncation."""
    if trunc is None:
        return None
    kind, rc = trunc
    kind = str(kind).lower()
    if kind not in ("0d", "2d"):
        raise ValueError(f"unknown truncation {kind!r} (use '0d' or '2d')")
    if omega:
        raise NotImplementedError(
            "range separation (omega) with a truncated Coulomb kernel")
    return (kind, float(rc))


def trunc_for_cell(cell, kind):
    """Conventional truncation radius for a cell: ('0d', L_min/2) from the
    minimum interplanar height, or ('2d', Lz/2) from the third lattice
    vector's out-of-plane height.  The density must be centred and
    contained well inside the truncation region (0d: diameter < rc)."""
    kind = str(kind).lower()
    a = np.asarray(cell.a, dtype=float)
    vol = abs(np.linalg.det(a))
    heights = np.array([
        vol / np.linalg.norm(np.cross(a[(i + 1) % 3], a[(i + 2) % 3]))
        for i in range(3)])
    if kind == "0d":
        return ("0d", float(heights.min()) / 2.0)
    if kind == "2d":
        return ("2d", float(heights[2]) / 2.0)
    raise ValueError(f"unknown truncation {kind!r} (use '0d' or '2d')")


def coulG_np(gv, trunc=None):
    """Host (numpy, f64) mirror of the kernel values.  Bare kernel: the
    divergent q+G = 0 sample is zeroed; truncated kernels keep their finite
    q+G = 0 value."""
    gv = np.asarray(gv, dtype=float)
    absg2 = np.einsum("gi,gi->g", gv, gv)
    ok = absg2 > 1e-12
    safe = np.where(ok, absg2, 1.0)
    if trunc is None:
        return np.where(ok, 4.0 * np.pi / safe, 0.0)
    kind, rc = trunc
    rc = float(rc)
    if kind == "0d":
        v = 4.0 * np.pi * (1.0 - np.cos(np.sqrt(safe) * rc)) / safe
        return np.where(ok, v, 2.0 * np.pi * rc * rc)
    if kind == "2d":
        gz = gv[:, 2]
        gp2 = gv[:, 0] ** 2 + gv[:, 1] ** 2
        pok = gp2 > 1e-12
        zok = gz * gz > 1e-12
        gp = np.sqrt(np.where(pok, gp2, 1.0))
        vp = (4.0 * np.pi / np.where(pok, absg2, 1.0)
              * (1.0 + np.exp(-gp * rc)
                 * ((gz / gp) * np.sin(gz * rc) - np.cos(gz * rc))))
        gz2 = np.where(zok, gz * gz, 1.0)
        vz = (4.0 * np.pi / gz2
              * (1.0 - np.cos(gz * rc) - gz * rc * np.sin(gz * rc)))
        return np.where(pok, vp,
                        np.where(zok, vz, -2.0 * np.pi * rc * rc))
    raise ValueError(f"unknown truncation {kind!r} (use '0d' or '2d')")


def get_coulG(cell, q=None, mesh=None, gv=None, omega=0.0, trunc=None,
              dtype=None, *, device="cuda"):
    """Kernel values on the FFT grid of ``mesh`` at momentum ``q``:
    (ngrid,) real of ``dtype`` on ``device``.

    ``omega``: range separation (0: full kernel); ``trunc``: None |
    ("0d", rc) | ("2d", rc) real-space truncation."""
    device = resolve_device(device)
    rdtype = real_complex(dtype)[0]
    if gv is None:
        gv = cell.get_Gv(mesh)
    gv = torch.as_tensor(gv, dtype=rdtype, device=device)
    if q is not None:
        gv = gv + torch.as_tensor(q, dtype=rdtype, device=device)[None, :]
    return _coulG_vec(gv, float(omega), check_trunc(trunc, omega))


def get_coulG_batched(cell, qs, gv, dtype=None, omega=0.0, trunc=None):
    """coulG for all momentum sectors: (nq, ngrid) real, on the device of
    ``gv``.  ``qs`` (nq, 3) and ``gv`` (ngrid, 3) are real tensors, cast to
    ``dtype`` when it is given."""
    if dtype is not None:
        rdtype = real_complex(dtype)[0]
        gv, qs = gv.to(rdtype), qs.to(rdtype)
    omega = float(omega)
    trunc = check_trunc(trunc, omega)
    out = torch.empty((qs.shape[0], gv.shape[0]), dtype=gv.dtype,
                      device=gv.device)
    for i in range(qs.shape[0]):
        out[i] = _coulG_vec(gv + qs[i][None, :], omega, trunc)
    return out
