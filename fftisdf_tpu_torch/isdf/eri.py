"""ERI assembly from the ISDF factorisation.

Counterpart of ``fftisdf_tpu/isdf/eri.py``:

    eri[m,n,k,l] = sum_IJ w^q_IJ conj(x1_Im) x2_In conj(x3_Jk) x4_Jl

with q = k2 - k1 (mod G), as two pair contractions around the (nip, nip)
metric.
"""
from __future__ import annotations


def assemble_eri(w_q, x1, x2, x3, x4):
    """(n1, n2, n3, n4) ERI block; the orbital counts may differ per slot."""
    nip = x1.shape[0]
    n1, n2, n3, n4 = (x.shape[1] for x in (x1, x2, x3, x4))
    t12 = (x1.conj()[:, :, None] * x2[:, None, :]).reshape(nip, n1 * n2)
    t34 = (x3.conj()[:, :, None] * x4[:, None, :]).reshape(nip, n3 * n4)
    return (t12.T @ (w_q @ t34)).reshape(n1, n2, n3, n4)
