"""Operations and bytes of one xc pass of a GGA (``scf.xc``: the spin
densities from the Bloch AOs on the full mesh, the functional and its
potential, the Vxc matrices), and its bound on one H100.

The count depends on the pass's shape alone, (nk, ng, nao, nspin) and
the complex type, never on how the program computes it:

- the density: per spin and k-point one (ng, nao) x (nao, nao) complex
  product, 8 ng nao^2 operations;
- the Vxc matrices: per spin and k-point one (nao, ng) x (ng, nao)
  complex product, 8 ng nao^2 operations;
- the GGA's FFTs: per spin the density's forward transform and three
  inverse ones for its gradient, and as many again in the potential (the
  derivative of the discrete energy), 5 ng log2(ng) operations each;
- bytes: the AO tensor (nk, ng, nao) read twice, once for the density
  and once for the matrices, the density matrices read and the Vxc
  matrices written once.

The elementwise work on the mesh (the functional, its derivative, the
density's products with the AOs) is left out: it is O(nk ng nao) beside
O(nk ng nao^2).  The bound is the larger of the operations at the peak
of the type's route (complex128 on the FP64 tensor cores, complex64 on
FP32 outside them: the program leaves TF32 off) and the bytes at the
memory's peak (``roofline.py``)."""
from __future__ import annotations

import math

from benchmark.harness.roofline import PEAK_BYTES, PEAK_FLOPS

# (peak unit, bytes of an element) by the AO tensor's complex type
ROUTE = {"complex128": ("fp64_tc", 16.0), "complex64": ("fp32", 8.0)}


def xc_count(nk, ng, nao, nspin=2, dname="complex128"):
    """(operations, bytes) of one xc pass of a GGA."""
    nk, ng, nao, nspin = (int(v) for v in (nk, ng, nao, nspin))
    csize = ROUTE[dname][1]
    gemm = 8.0 * ng * nao * nao * nk * nspin
    ffts = 2 * 4 * nspin
    flops = 2.0 * gemm + ffts * 5.0 * ng * math.log2(ng)
    nbytes = csize * (2.0 * nk * ng * nao + 2.0 * nspin * nk * nao * nao)
    return flops, nbytes


def xc_bound(nk, ng, nao, nspin=2, dname="complex128"):
    """(operations, bytes, bound seconds, 'operations' | 'bytes') of one
    xc pass."""
    flops, nbytes = xc_count(nk, ng, nao, nspin, dname)
    t_ops = flops / PEAK_FLOPS[ROUTE[dname][0]]
    t_bytes = nbytes / PEAK_BYTES
    return flops, nbytes, max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")
