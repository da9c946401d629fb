"""Peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the full
700 W power limit) and the operations and bytes of kernel K1.

K1's bound is a frozen copy of ``chip_smoke.py::k1_bound`` (phase 1;
PERF.md's kernel table): the upper triangle of the (ng, ng) pair gram,
4 ng (ng + 1) K flops with K = nk nao, times the passes of the route, at
the route's peak, against X read once and the result written once.  It
depends on the launch's shape alone, never on how the program computes
it."""
from __future__ import annotations

PEAK_FLOPS = {"fp64_tc": 67e12, "tf32_tc": 495e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
# (peak unit, passes) of K1's route per element type: complex128 on the
# FP64 tensor cores (DMMA), complex64 as 3xTF32 on the tensor cores
ROUTE = {"complex128": ("fp64_tc", 1), "complex64": ("tf32_tc", 3)}


def k1_bound(shape, dname="complex128"):
    """(flops, bound seconds, 'operations' | 'bytes') of one K1 launch on
    X of ``shape`` = (nk, ng, nao) in ``dname``."""
    nk, ng, nao = (int(v) for v in shape)
    kk = nk * nao
    flops = 4.0 * ng * (ng + 1) * kk
    unit, passes = ROUTE[dname]
    csize = 16.0 if dname == "complex128" else 8.0
    nbytes = csize * ng * kk + 0.5 * csize * ng * ng
    t_ops = passes * flops / PEAK_FLOPS[unit]
    t_bytes = nbytes / PEAK_BYTES
    return flops, max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")
