"""ERI assembly from the ISDF factorisation.

Counterpart of ``fftisdf_tpu/isdf/eri.py``:

    eri[m,n,k,l] = sum_IJ w^q_IJ conj(x1_Im) x2_In conj(x3_Jk) x4_Jl

with q = k2 - k1 (mod G), as two pair contractions around the (nip, nip)
metric.
"""
from __future__ import annotations


def pair_vectors(a, b):
    """(..., nip, na), (..., nip, nb) -> (..., nip, na*nb): the pair
    products conj(a_Im) b_In at each interpolation point I."""
    p = a.conj()[..., :, None] * b[..., None, :]
    return p.reshape(*p.shape[:-2], a.shape[-1] * b.shape[-1])


def assemble_eri(w_q, x1, x2, x3, x4):
    """(n1, n2, n3, n4) ERI block; the orbital counts may differ per slot."""
    n1, n2, n3, n4 = (x.shape[1] for x in (x1, x2, x3, x4))
    t12 = pair_vectors(x1, x2)
    t34 = pair_vectors(x3, x4)
    return (t12.T @ (w_q @ t34)).reshape(n1, n2, n3, n4)
