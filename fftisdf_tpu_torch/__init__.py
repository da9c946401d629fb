"""fftisdf_tpu_torch — the PyTorch/CUDA port of ``fftisdf_tpu``.

The main path of the JAX package, ported module by module with the same
layout: Bloch-AO evaluation (``basis``), FFTs, the Coulomb kernel, pivoted
Cholesky and the ridge fitting solver (``linalg``), interpolation-point
selection, the metric pass and the J/K serve (``isdf``), and the
one-electron integrals and the KRHF/KUHF SCF (``scf``).  The one TPU kernel
of the JAX package, the selection pair gram, is a hand-written CUDA kernel
(``ops/csrc/pair_gram.cu``).

Computation is float64/complex128 on every device; every entry point takes
an explicit ``device``.  The numpy layer (cells, k-points, basis tables,
the native lattice engine) is shared with the JAX package through
:mod:`fftisdf_tpu_torch._shared`, which never imports JAX itself.
"""
