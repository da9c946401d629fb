"""K1: the squared pair-density gram of interpolation-point selection.

Replaces ``fftisdf_tpu/ops/pallas_gram.py::pair_gram_sq`` (the repo's one
Pallas kernel).  For X (nk, ng, nao) complex,

    x4[g,h] = (|sum_{k,m} conj(X[k,g,m]) X[k,h,m]|^2 / nk^2)^(1 or 2).

:func:`pair_gram_sq` launches the hand-written CUDA kernel
(``csrc/pair_gram.cu``, built at first use by :mod:`._build`) for a CUDA
tensor and takes the plain version, :func:`pair_gram_sq_reference`, for a
CPU tensor.  It never falls back from the kernel to the plain version.
``pair_gram_sq.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from fftisdf_tpu_torch.ops._build import KernelLibrary

LIBRARY = KernelLibrary("pair_gram")
_ENTRY = {torch.complex128: ("pair_gram_sq_f64", ctypes.c_double),
          torch.complex64: ("pair_gram_sq_f32", ctypes.c_float)}


def pair_gram_sq_reference(x, square=True):
    """Plain PyTorch version: complex einsum, then the modulus."""
    if x.ndim == 2:
        x = x[None]
    nk = x.shape[0]
    g = torch.einsum("kgm,khm->gh", x.conj(), x) / nk
    out = g.real * g.real + g.imag * g.imag
    return out * out if square else out


def _entry_point(dtype):
    name, ctype = _ENTRY[dtype]
    fn = getattr(LIBRARY.load(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctype, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


def pair_gram_sq(x, square=True):
    """x4[g,h] = (|sum_k conj(X_k) X_k^T|^2 / nk^2)^(2 if square else 1).

    ``x``: (nk, ng, nao) or (ng, nao) complex64/complex128.  Returns the
    real (ng, ng) result of the matching precision on ``x``'s device."""
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3:
        raise ValueError(f"expected (nk, ng, nao), got shape {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"expected complex64/complex128, got {x.dtype}")
    if x.device.type == "cpu":
        return pair_gram_sq_reference(x, square=square)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    nk, ng, nao = x.shape
    kk = nk * nao
    if ng * max(ng, kk) >= 2**31:
        raise ValueError(f"pair_gram_sq: shape {tuple(x.shape)} exceeds the "
                         "kernel's 32-bit extents")
    # (k, ao) flattened into the contraction axis; contiguous real planes
    xt = x.permute(1, 0, 2).reshape(ng, kk)
    xr = xt.real.contiguous()
    xi = xt.imag.contiguous()
    if ng == 0 or kk == 0:      # an empty grid launches nothing
        return torch.zeros((ng, ng), dtype=xr.dtype, device=x.device)
    out = torch.empty((ng, ng), dtype=xr.dtype, device=x.device)
    fn = _entry_point(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(xr.data_ptr(), xi.data_ptr(), out.data_ptr(), ng, kk,
                1.0 / nk, int(bool(square)), stream)
    if rc != 0:
        raise RuntimeError(f"pair_gram_sq kernel launch failed: CUDA error "
                           f"{rc}")
    pair_gram_sq.launches += 1
    return out


pair_gram_sq.launches = 0
