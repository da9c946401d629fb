"""The port's ISDF-compact cderi factors and their GDF-style J/K serve
against the JAX package (CPU, float64).

Counterpart of tests/test_cderi.py with its gates: the PSD factors pair
into the metric-form ERIs to 1e-6 of the scale, the signed factors to
1e-8, and the signed J/K equal the ISDF serve to 1e-8 (the PSD ones to
1e-6).  Both packages factor the same metric (the port's build, handed to
the JAX functions as arrays), so their factors, sign vectors, q tables
and J/K are compared directly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.isdf import cderi as jax_cd
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.isdf import cderi as cd_mod
from fftisdf_tpu_torch.lattice.cell import Cell
from test_torch_omega_trunc import HE2, trs_dm
from torch_test_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def he2_df():
    """tests/test_cderi.py's build: He2, kmesh 1x2x2, c0 12, m0 7x7x9."""
    cell = Cell(**HE2).build()
    kpts = cell.get_kpts([1, 2, 2])
    df = FFTISDF(cell, kpts, c0=12.0, m0=(7, 7, 9), verbose=0,
                 device="cpu").build()
    dm = trs_dm(cell, kpts, cell.nao_nr())
    return cell, kpts, df, dm


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _gram(cd, sign=None):
    """cd^H diag(sign) cd per sector."""
    cd = _np(cd)
    s = np.ones(cd.shape[:2]) if sign is None else _np(sign)
    return np.einsum("qPI,qP,qPJ->qIJ", cd.conj(), s, cd)


def test_q_index_table_matches_jax(he2_df):
    cell, kpts, df, _ = he2_df
    q_of = cd_mod.q_index_table(cell, kpts)
    np.testing.assert_array_equal(
        q_of, jax_cd.q_index_table(JaxCell(**HE2).build(), kpts))
    np.testing.assert_array_equal(q_of, df.kconserv2())


def test_cderi_factors_match_jax(he2_df):
    """Eigenvectors carry a free phase, so the factors are compared
    through the quadratic forms they reproduce: cd^H diag(sign) cd equals
    the hermitised metric to 1e-10 of its scale (the JAX gate), and each
    package's form equals the other's; the sign vectors are equal away
    from the roundoff floor."""
    _, _, df, _ = he2_df
    wq = df.wq.numpy()
    w_h = 0.5 * (wq + np.conj(np.swapaxes(wq, -1, -2)))
    scale = np.abs(w_h).max()
    cd, sgn = cd_mod.wq_to_cd_signed(df.wq)
    cd_j, sgn_j = jax_cd.wq_to_cd_signed(jnp.asarray(wq))
    assert cd.shape == (len(wq), df.nip, df.nip)
    # the sign of an eigenvalue at the roundoff floor is either package's
    big = np.abs(np.linalg.eigvalsh(w_h)) > 1e-10 * scale
    np.testing.assert_array_equal(_np(sgn)[big], np.asarray(sgn_j)[big])
    np.testing.assert_allclose(_gram(cd, sgn), w_h, atol=1e-10 * scale)
    np.testing.assert_allclose(_gram(cd, sgn), _gram(cd_j, sgn_j),
                               atol=1e-10 * scale)
    psd = _gram(cd_mod.wq_to_cd(df.wq))
    np.testing.assert_allclose(psd, _gram(jax_cd.wq_to_cd(jnp.asarray(wq))),
                               atol=1e-10 * scale)
    # the clip moves the near-null (fit-noise) directions only
    np.testing.assert_allclose(psd, w_h, atol=1e-6 * scale)


@pytest.mark.parametrize("signed", [False, True])
def test_cderi_eri_pairing(he2_df, signed):
    """sum_P sign_P A12 conj(A43) equals the metric-form ERI: to the PSD
    clip (1e-6 of the scale) or, signed, to 1e-8; and the JAX package's
    assembly of the same factors."""
    _, _, df, _ = he2_df
    cd, sgn = cd_mod.wq_to_cd_signed(df.wq) if signed else (
        cd_mod.wq_to_cd(df.wq), None)
    tol = 1e-8 if signed else 1e-6
    k3c = df.kconserv3()
    for kidx in [(0, 0, 0, 0), (0, 1, 2, int(k3c[0, 1, 2])),
                 (1, 3, 0, int(k3c[1, 3, 0]))]:
        q = int(df.kconserv2()[kidx[0], kidx[1]])
        xs = [df.x_k[k] for k in kidx]
        sq = None if sgn is None else sgn[q]
        eri = cd_mod.assemble_eri_cderi(cd[q], *xs, sign_q=sq).numpy()
        ref = df.get_eri(kidx).numpy()
        scale = max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(eri, ref, atol=tol * scale)
        eri_j = jax_cd.assemble_eri_cderi(
            jnp.asarray(cd[q].numpy()), *(jnp.asarray(x.numpy()) for x in xs),
            sign_q=None if sq is None else jnp.asarray(sq.numpy()))
        np.testing.assert_allclose(eri, np.asarray(eri_j),
                                   atol=1e-12 * scale)
        a = cd_mod.pair_cderi(cd[q], xs[0], xs[1]).numpy()
        np.testing.assert_allclose(a, np.asarray(jax_cd.pair_cderi(
            jnp.asarray(cd[q].numpy()), jnp.asarray(xs[0].numpy()),
            jnp.asarray(xs[1].numpy()))), atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("signed,k2_chunk", [(True, 2), (True, None),
                                             (False, 1)])
def test_get_jk_cderi_matches_jax_and_serve(he2_df, signed, k2_chunk):
    """The GDF-style J/K of the port equal the JAX package's on the same
    factors (1e-12), and the ISDF serve: 1e-8 signed, 1e-6 PSD."""
    cell, kpts, df, dm = he2_df
    cd, sgn = cd_mod.wq_to_cd_signed(df.wq) if signed else (
        cd_mod.wq_to_cd(df.wq), None)
    q_of = cd_mod.q_index_table(cell, kpts)
    vj, vk = cd_mod.get_jk_cderi(df.x_k, cd, q_of, dm, k2_chunk=k2_chunk,
                                 sign=sgn)
    vj_j, vk_j = jax_cd.get_jk_cderi(
        jnp.asarray(df.x_k.numpy()), jnp.asarray(cd.numpy()),
        jnp.asarray(q_of), jnp.asarray(dm), k2_chunk=k2_chunk,
        sign=None if sgn is None else jnp.asarray(sgn.numpy()))
    np.testing.assert_allclose(vj.numpy(), np.asarray(vj_j), atol=1e-12)
    np.testing.assert_allclose(vk.numpy(), np.asarray(vk_j), atol=1e-12)
    vj0, vk0 = df.get_jk(dm)
    tol = 1e-8 if signed else 1e-6
    np.testing.assert_allclose(vj.numpy(), vj0.numpy(), atol=tol)
    np.testing.assert_allclose(vk.numpy(), vk0.numpy(), atol=tol)


def test_cderi_guards(he2_df):
    """k2_chunk must divide nk; naux = nip < ngrid."""
    cell, kpts, df, dm = he2_df
    cd = cd_mod.wq_to_cd(df.wq)
    assert df.nip < int(np.prod(cell.mesh))
    with pytest.raises(ValueError):
        cd_mod.get_jk_cderi(df.x_k, cd, cd_mod.q_index_table(cell, kpts),
                            dm, k2_chunk=3)
