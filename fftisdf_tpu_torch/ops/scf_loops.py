"""The SCF cycle's fixed-trip loops: the ADIIS mirror descent and the
chemical-potential bisection.

Each has a plain PyTorch version (the loop, one tensor op at a time) and a
hand-written single-block CUDA kernel (``csrc/scf_loops.cu``, built at first
use by :mod:`._build`) that runs every step on the card in one launch.
:func:`adiis_descent` and :func:`smeared_bisect` launch the kernel for CUDA
tensors and take the plain version for CPU tensors; they never fall back
from the kernel to the plain version.  Each keeps a plain integer count of
its kernel launches (``adiis_descent.launches``,
``smeared_bisect.launches``) and adds each launch to the recorder's
counters ``ops.adiis_descent`` and ``ops.smeared_bisect``
(:mod:`fftisdf_tpu_torch.utils.profiling`).  Both take float32 or float64.
"""
from __future__ import annotations

from ctypes import POINTER, c_double, c_int, c_void_p

import numpy as np
import torch

from fftisdf_tpu_torch.ops._build import KernelLibrary
from fftisdf_tpu_torch.utils import profiling

LIBRARY = KernelLibrary("scf_loops")
_SUFFIX = {torch.float64: "d", torch.float32: "f"}
# one block: a thread per simplex slot
MAX_M = 1024
# one block per spin; the kernel takes the electron counts by value
MAX_SPINS = 2


def _real_dtype(*tensors):
    dt = tensors[0].dtype
    if dt not in _SUFFIX:
        raise TypeError(f"expected float32/float64, got {dt}")
    for t in tensors[1:]:
        if t.dtype != dt:
            raise TypeError(f"mixed dtypes {dt} and {t.dtype}")
    return dt


def _check_device(*tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError("inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous inputs")
    return dev


def _launch(name, dtype, argtypes, args, device):
    fn = getattr(LIBRARY.load(), f"{name}_{_SUFFIX[dtype]}")
    fn.restype = c_int
    fn.argtypes = argtypes + [c_void_p]
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------- ADIIS
def adiis_descent_reference(a, bb, vf, n_steps=400):
    """Plain PyTorch version: the descent as a loop of tensor ops."""
    tiny = torch.finfo(a.dtype).tiny
    c = vf / vf.sum()
    for t in range(n_steps):
        g = (2.0 * a + bb @ c) * vf
        g = g - (c * g).sum()                    # tangent of the simplex
        gmax = (g.abs() * vf).max() + tiny
        c = c * torch.exp(-(2.0 / (1.0 + 0.02 * t)) * g / gmax) * vf
        c = c / (c.sum() + tiny)
    return c


def adiis_descent(a, bb, vf, n_steps=400):
    """Entropic mirror descent of the ADIIS model over the simplex:
    ``n_steps`` steps of c <- c exp(-eta_t g / max|g|), renormalised, with
    g = (2 a + bb c) projected on the simplex's tangent and eta_t =
    2 / (1 + 0.02 t), from c = vf / sum(vf).

    a: (m,) linear term, bb: (m, m) symmetric quadratic term, vf: (m,) 0/1
    live-slot mask (dead slots stay at 0), all float32 or float64 on one
    device, 1 <= m <= 1024.  Returns c (m,)."""
    dt = _real_dtype(a, bb, vf)
    m = a.shape[0] if a.ndim == 1 else -1
    if m < 1 or tuple(vf.shape) != (m,) or tuple(bb.shape) != (m, m):
        raise ValueError(f"expected a, vf (m,) and bb (m, m), got "
                         f"{tuple(a.shape)}, {tuple(vf.shape)}, "
                         f"{tuple(bb.shape)}")
    if m > MAX_M:
        raise ValueError(f"adiis_descent: m = {m} exceeds one block "
                         f"({MAX_M})")
    dev = _check_device(a, bb, vf)
    if dev.type == "cpu":
        return adiis_descent_reference(a, bb, vf, n_steps)
    c = torch.empty_like(a)
    _launch("adiis_descent", dt,
            [c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int, c_double],
            (a.data_ptr(), bb.data_ptr(), vf.data_ptr(), c.data_ptr(), m,
             int(n_steps), torch.finfo(dt).tiny), dev)
    adiis_descent.launches += 1
    profiling.count("ops.adiis_descent")
    return c


adiis_descent.launches = 0


# ------------------------------------------------------------ bisection
def _limits(dtype):
    """(clip of (e - mu) / sigma, f_lo, f_hi of the Fermi entropy) of a
    real dtype."""
    if torch.finfo(dtype).bits == 64:
        return 600.0, 1e-300, 1.0 - 1e-16
    return 60.0, 1e-30, 1.0 - 1e-7


def _smeared_one(e, ok, nelec_target, sigma, method):
    """One spin's bisection, the plain loop: (f, entropy, mu)."""
    clip, f_lo, f_hi = _limits(e.dtype)
    big = 1e30

    def nelec(mu):
        x = ((e - mu) / sigma).clamp(-clip, clip)
        if method == "fermi":
            f = 1.0 / (1.0 + torch.exp(x))
        else:
            f = 0.5 * torch.special.erfc(x)
        f = torch.where(ok, f, 0.0)
        return f.sum(), f

    lo = torch.where(ok, e, big).min() - 45.0 * sigma
    hi = torch.where(ok, e, -big).max() + 45.0 * sigma
    for _ in range(90):
        mu = 0.5 * (lo + hi)
        below = nelec(mu)[0] < nelec_target
        lo, hi = torch.where(below, mu, lo), torch.where(below, hi, mu)
    mu = 0.5 * (lo + hi)
    f = nelec(mu)[1]
    if method == "fermi":
        fc = f.clamp(f_lo, f_hi)
        s = -(fc * torch.log(fc) + (1.0 - fc) * torch.log1p(-fc))
        s = torch.where(ok & (f > f_lo) & (f < f_hi), s, 0.0)
    else:
        x = (e - mu) / sigma
        s = torch.where(ok, torch.exp(-x * x) / (2.0 * np.sqrt(np.pi)), 0.0)
    return f, s.sum(), mu


def smeared_bisect_reference(e, ok, targets, sigma, method):
    """Plain PyTorch version: each spin's bisection as a loop of tensor
    ops."""
    outs = [_smeared_one(e[s], ok[s], float(t), sigma, method)
            for s, t in enumerate(targets)]
    return tuple(torch.stack(v) for v in zip(*outs))


def smeared_bisect(e, ok, targets, sigma, method):
    """Fractional occupations of each spin from its own bisected chemical
    potential.

    e: (ns, ...) eigenvalues, float32 or float64, ns <= 2; ok: same-shape
    bool (False: a dropped or padded slot, occupation exactly 0); targets:
    ns electron counts; sigma > 0; method "fermi" (Fermi-Dirac) or any
    other name for the Gaussian.  ``sum(f[s])`` is bisected to
    ``targets[s]`` in 90 steps.  Returns ``(f, entropy, mu)``: f shaped as
    e, the dimensionless entropy S of the Mermin free energy E - sigma S
    and mu, each (ns,)."""
    dt = _real_dtype(e)
    if e.ndim < 1 or ok.shape != e.shape or ok.dtype != torch.bool:
        raise ValueError(f"expected e (ns, ...) and a bool ok of its shape, "
                         f"got {tuple(e.shape)} and {ok.dtype} "
                         f"{tuple(ok.shape)}")
    ns = e.shape[0]
    n = e[0].numel() if ns else 0
    targets = [float(t) for t in targets]
    if not 1 <= ns <= MAX_SPINS or len(targets) != ns or n < 1:
        raise ValueError(f"expected 1 to {MAX_SPINS} non-empty spins and a "
                         f"target each, got e {tuple(e.shape)} and "
                         f"{len(targets)} targets")
    if not sigma > 0.0:
        raise ValueError(f"smeared_bisect needs sigma > 0, got {sigma}")
    dev = _check_device(e, ok)
    if dev.type == "cpu":
        return smeared_bisect_reference(e, ok, targets, sigma, method)
    if ns * n >= 2**31:
        raise ValueError(f"smeared_bisect: shape {tuple(e.shape)} exceeds "
                         "the kernel's 32-bit extents")
    clip, f_lo, f_hi = _limits(dt)
    f = torch.empty_like(e)
    ent = torch.empty(ns, dtype=dt, device=dev)
    mu = torch.empty(ns, dtype=dt, device=dev)
    tgt = (c_double * ns)(*targets)
    _launch("smeared_bisect", dt,
            [c_void_p, c_void_p, c_int, c_int, POINTER(c_double), c_double,
             c_double,
             c_int, c_double, c_double, c_void_p, c_void_p, c_void_p],
            (e.data_ptr(), ok.data_ptr(), ns, n, tgt, float(sigma), clip,
             int(method == "fermi"), f_lo, f_hi, f.data_ptr(), ent.data_ptr(),
             mu.data_ptr()), dev)
    smeared_bisect.launches += 1
    profiling.count("ops.smeared_bisect")
    return f, ent, mu


smeared_bisect.launches = 0
