"""Periodic Poisson solves for Bloch pair densities.

Counterpart of ``fftisdf_tpu/pw/poisson.py``.  A pair density with Bloch
momentum q, rho(r) = e^{iq.r} u(r) with u lattice-periodic, has the
periodic Coulomb potential

    V(r) = e^{iq.r} IFFT[ FFT[rho e^{-iq.r}] coulG(q) ](r)

with ``coulG(q)[G] = 4 pi / |q+G|^2`` and numpy's FFT normalisation (the
inverse divides by N).  No volume factor: the 1/N of the inverse supplies
the (1/vol) (vol/N) quadrature of the forward Fourier coefficients; matrix
elements then take the real-space weight vol/ngrid.
"""
from __future__ import annotations

import torch

from fftisdf_tpu_torch.linalg.coulomb import get_coulG
from fftisdf_tpu_torch.linalg.fft import fft3, ifft3
from fftisdf_tpu_torch.utils.device import as_tensor, real_complex


def eiqr(coords, q):
    """e^{i q.r} on the grid of ``coords`` (ngrid, 3), a real tensor, for
    momenta ``q`` (..., 3): (..., ngrid) complex of the matching precision
    on the device of ``coords``."""
    t = as_tensor(q, coords.device, coords.dtype) @ coords.T
    return torch.polar(torch.ones_like(t), t)


def pair_potential(rho, q, coords, cell, mesh=None, coulG=None):
    """Coulomb potential of Bloch pair densities ``rho`` (..., ngrid)
    complex with momentum ``q`` (3,); ``coords`` (ngrid, 3).  Returns V of
    the same shape and precision, per grid point (no quadrature weight).
    ``coulG`` overrides the bare kernel (a screened or truncated one from
    ``linalg.coulomb.get_coulG``)."""
    mesh = cell.mesh if mesh is None else mesh
    dev = rho.device
    rdt = real_complex(rho.dtype)[0]
    if coulG is None:
        coulG = get_coulG(cell, q=q, mesh=mesh, dtype=rdt, device=dev)
    ph = eiqr(as_tensor(coords, dev, rdt), q)
    work = fft3(rho * ph.conj(), mesh) * coulG
    return ifft3(work, mesh) * ph
