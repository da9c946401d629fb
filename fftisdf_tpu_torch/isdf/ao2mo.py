"""AO -> MO and embedding-space ERI transforms from the ISDF state.

Counterpart of ``fftisdf_tpu/isdf/ao2mo.py`` (the reference's unfinished
``trans_2e``, its ``fftisdf.py:230-294``): with the state
(x_k, w_q) an orbital-basis ERI is three small matmuls away, because the
AO index enters only through x_{k,I,m} -> xmo_{k,I,i} = sum_m x_{k,I,m}
C_{k,m,i}.  Tensors stay on the device of the ISDF object.
"""
from __future__ import annotations

import numpy as np
import torch

from fftisdf_tpu_torch.isdf.eri import assemble_eri, pair_vectors
from fftisdf_tpu_torch.utils.device import as_tensor


def mo_eri(df, mo_coeffs, kidx, wq=None):
    """MO ERI (n1, n2, n3, n4) of one momentum-conserving quadruple
    ``kidx = (k1, k2, k3, k4)``:

        (i k1, j k2 | k k3, l k4) = sum_IJ w^q_IJ conj(xmo1_Ii) xmo2_Ij
                                                conj(xmo3_Jk) xmo4_Jl.

    ``mo_coeffs``: (C1, C2, C3, C4), each (nao, nmo_i).  ``wq``: another
    metric over the same interpolation basis (e.g. ``df.get_wq_omega``);
    the bare ``df.wq`` by default."""
    k1, k2, k3, k4 = (int(k) for k in kidx)
    if df.kconserv3()[k1, k2, k3] != k4:
        raise ValueError(f"quadruple {kidx} does not conserve momentum")
    q = int(df.kconserv2()[k1, k2])
    x = df.x_k
    xs = [x[k] @ as_tensor(c, x.device, x.dtype)
          for k, c in zip((k1, k2, k3, k4), mo_coeffs)]
    return assemble_eri((df.wq if wq is None else wq)[q], *xs)


def trans_2e(df, c_ao_lo=None):
    """Embedding-space ERI (nemb, nemb, nemb, nemb) of the supercell's
    R = 0 local orbitals:

        eri = (1/nk) sum_{k1 k2 k3} assemble(w^q, xlo_k1, xlo_k2, xlo_k3,
                                             xlo_k4),  k4 by conservation,

    ``c_ao_lo`` (nk, nao, nemb) the k-resolved AO -> local-orbital
    coefficients (identity per k when None, the k2gamma AO transform of
    ref ``fftisdf.py:246-250``).  For nk = 1 it is the plain MO ERI.

    The sum over k3 of a (k1, k2) row, whose triples share w^q and the
    pair vectors of (k1, k2), is taken on the (k3, k4) pair vectors
    first: one product a row (the JAX package assembles each triple)."""
    nk = df.nkpt
    x = df.x_k
    nao = x.shape[2]
    if c_ao_lo is None:
        c_ao_lo = np.broadcast_to(np.eye(nao), (nk, nao, nao))
    c = as_tensor(np.asarray(c_ao_lo).astype(complex), x.device, x.dtype)
    k2c, k3c = df.kconserv2(), df.kconserv3()
    xlo = x @ c                                      # (nk, nip, nemb)
    n = xlo.shape[2]
    out = None
    for k1 in range(nk):
        for k2 in range(nk):
            k4s = torch.as_tensor(k3c[k1, k2], device=x.device)
            t34 = pair_vectors(xlo, xlo[k4s]).sum(0)     # sum over k3
            t = (pair_vectors(xlo[k1], xlo[k2]).T
                 @ (df.wq[int(k2c[k1, k2])] @ t34)).reshape(n, n, n, n)
            out = t if out is None else out + t
    return out / nk
