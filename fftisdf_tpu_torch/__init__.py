"""fftisdf_tpu_torch — the PyTorch/CUDA port of ``fftisdf_tpu``.

The main path of the JAX package, ported module by module with the same
layout: Bloch-AO evaluation (``basis``), FFTs, the Coulomb kernel, pivoted
Cholesky and the ridge fitting solver (``linalg``), interpolation-point
selection, the metric pass and the J/K serve (``isdf``), and the
one-electron integrals and the KRHF/KUHF SCF (``scf``).  The one TPU kernel
of the JAX package, the selection pair gram, is a hand-written CUDA kernel
(``ops/csrc/pair_gram.cu``).

Computation is float64/complex128 on every device.  Every entry point runs
on the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
The host-side numpy layer (cells, k-points, basis tables, the native
lattice engine) is the port's own copy of the JAX package's, under the same
module names (``lattice``, ``basis.data``, ``basis.gto``, ``native``,
``utils.logging``); the port imports nothing of the JAX package.
"""
