"""Reciprocal-space Coulomb kernel, bare 3D form.

Counterpart of ``fftisdf_tpu/linalg/coulomb.py`` for the case the main path
uses: the 3D periodic kernel with ``exxdiv=None``,

    coulG(q)[G] = 4 pi / |q + G|^2,    coulG = 0 where |q + G| = 0.

Range separation (``omega``) and the 0D/2D truncated kernels are not ported
yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from fftisdf_tpu_torch.utils.device import REAL, resolve_device


def _check_bare(omega, trunc):
    if omega:
        raise NotImplementedError("range-separated Coulomb kernels (omega)")
    if trunc is not None:
        raise NotImplementedError("truncated Coulomb kernels (trunc)")


def _coulG_vec(gk, omega=0.0, trunc=None):
    """Kernel values from the full q+G vectors (..., ng, 3)."""
    _check_bare(omega, trunc)
    absg2 = (gk * gk).sum(dim=-1)
    ok = absg2 > 1e-12
    safe = torch.where(ok, absg2, torch.ones_like(absg2))
    return torch.where(ok, 4.0 * math.pi / safe, torch.zeros_like(absg2))


def get_coulG(cell, q=None, mesh=None, omega=0.0, trunc=None, *,
              device="cuda"):
    """Kernel values on the FFT grid of ``mesh`` at momentum ``q``:
    (ngrid,) real on ``device``."""
    _check_bare(omega, trunc)
    device = resolve_device(device)
    gv = torch.as_tensor(cell.get_Gv(mesh), dtype=REAL, device=device)
    if q is not None:
        gv = gv + torch.as_tensor(q, dtype=gv.dtype, device=device)[None, :]
    return _coulG_vec(gv)


def get_coulG_batched(cell, qs, gv, omega=0.0, trunc=None):
    """coulG for all momentum sectors: (nq, ngrid) real, on the device of
    ``gv``.  ``qs`` (nq, 3) and ``gv`` (ngrid, 3) are real tensors."""
    _check_bare(omega, trunc)
    out = torch.empty((qs.shape[0], gv.shape[0]), dtype=gv.dtype,
                      device=gv.device)
    for i in range(qs.shape[0]):
        out[i] = _coulG_vec(gv + qs[i][None, :])
    return out
