"""K1: the squared pair-density gram of interpolation-point selection.

Replaces ``fftisdf_tpu/ops/pallas_gram.py::pair_gram_sq`` (the repo's one
Pallas kernel).  For X (nk, ng, nao) complex,

    x4[g,h] = (|sum_{k,m} conj(X[k,g,m]) X[k,h,m]|^2 / nk^2)^(1 or 2).

:func:`pair_gram_sq` launches the hand-written CUDA kernel
(``csrc/pair_gram.cu``, built at first use by :mod:`._build`) for a CUDA
tensor and takes the plain version, :func:`pair_gram_sq_reference`, for a
CPU tensor.  It never falls back from the kernel to the plain version.
``pair_gram_sq.launches`` counts kernel launches and
``pair_gram_sq.last_launch`` holds the shape and dtype of the latest one.
Both entries read X in place through its strides: complex128 runs on the
FP64 tensor cores (DMMA), complex64 on the TF32 tensor cores in 3xTF32
(each FP32 operand split into two TF32 halves, FP32 accumulation).
"""
from __future__ import annotations

from ctypes import c_double, c_int, c_int64, c_void_p

import torch

from fftisdf_tpu_torch.ops._build import KernelLibrary

LIBRARY = KernelLibrary("pair_gram")
# entry point and the byte alignment it needs of X, per dtype
_ENTRY = {torch.complex128: ("pair_gram_sq_z", 16),
          torch.complex64: ("pair_gram_sq_f32", 8)}
# (x, sk, sg, sm, nk, ng, nao, out, inv_nk, square, stream) of both entries
_ARGTYPES = [c_void_p, c_int64, c_int64, c_int64, c_int, c_int, c_int,
             c_void_p, c_double, c_int, c_void_p]


def pair_gram_sq_reference(x, square=True):
    """Plain PyTorch version: complex einsum, then the modulus."""
    if x.ndim == 2:
        x = x[None]
    nk = x.shape[0]
    g = torch.einsum("kgm,khm->gh", x.conj(), x) / nk
    out = g.real * g.real + g.imag * g.imag
    return out * out if square else out


def pair_gram_sq(x, square=True):
    """x4[g,h] = (|sum_k conj(X_k) X_k^T|^2 / nk^2)^(2 if square else 1).

    ``x``: (nk, ng, nao) or (ng, nao) complex64/complex128, any strides.
    Returns the real (ng, ng) result of the matching precision on ``x``'s
    device."""
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
    if ng == 0 or kk == 0:
        return torch.zeros((ng, ng), dtype=x.real.dtype, device=x.device)
    # read in place through the strides; a conjugate view carries a flag,
    # not conjugated data
    x = x.resolve_conj()
    name, align = _ENTRY[x.dtype]
    if x.data_ptr() % align:
        raise ValueError(f"pair_gram_sq: {x.dtype} input must be "
                         f"{align}-byte aligned")
    out = torch.empty((ng, ng), dtype=x.real.dtype, device=x.device)
    fn = getattr(LIBRARY.load(), name)
    fn.restype = c_int
    fn.argtypes = _ARGTYPES
    args = (x.data_ptr(), *x.stride(), nk, ng, nao, out.data_ptr(), 1.0 / nk,
            int(bool(square)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"pair_gram_sq kernel launch failed: CUDA error "
                           f"{rc}")
    pair_gram_sq.launches += 1
    pair_gram_sq.last_launch = ((nk, ng, nao), x.dtype)
    return out


pair_gram_sq.launches = 0
pair_gram_sq.last_launch = None
