"""Batched 3D FFTs over a flat, C-ordered grid axis.

Counterpart of ``fftisdf_tpu/linalg/fft.py``: arrays carry a last axis of
size prod(mesh), laid out with the last mesh axis fastest (as
``Cell.gen_uniform_grids``); numpy normalisation (the inverse divides by
ngrid).
"""
from __future__ import annotations

import torch


def fft3(f, mesh):
    """FFT over the last (flat grid) axis: f[..., ngrid] -> f~[..., ngrid]."""
    mesh = tuple(int(m) for m in mesh)
    shape = f.shape
    g = torch.fft.fftn(f.reshape(shape[:-1] + mesh), dim=(-3, -2, -1))
    return g.reshape(shape)


def ifft3(f, mesh):
    """Inverse FFT over the last (flat grid) axis, 1/ngrid included."""
    mesh = tuple(int(m) for m in mesh)
    shape = f.shape
    g = torch.fft.ifftn(f.reshape(shape[:-1] + mesh), dim=(-3, -2, -1))
    return g.reshape(shape)
