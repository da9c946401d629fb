"""The port's exact plane-wave oracle (``pw``, ``PWDF``), its Madelung
constant and the ``exxdiv='ewald'`` / ``get_eri`` serve of FFTISDF against
the JAX package, on diamond gth-szv ke 50, kmesh 1x1x2 (CPU, f64).

Tolerances are the JAX package's own: exact J/K and ERIs to 1e-10
relative, Madelung to 1e-12, compressed ISDF serves to 1e-8 relative
(test_torch_isdf_kpoint.py), full-rank ISDF against the exact oracle to
1e-9 (test_full_rank_jk_exact).  The port's ISDF is given the JAX
package's interpolation points.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from fftisdf_tpu.isdf import FFTISDF as JaxISDF
from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.pw import eri as jax_pw_eri, jk as jax_pw_jk
from fftisdf_tpu.scf import integrals as jax_integrals
from fftisdf_tpu.scf.hf import PWDF as JaxPWDF, KRHF as JaxKRHF
from fftisdf_tpu_torch.basis.eval import eval_ao_kpts
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.pw import eri as pw_eri, jk as pw_jk
from fftisdf_tpu_torch.scf import KRHF, PWDF
from fftisdf_tpu_torch.scf import integrals
from test_torch_isdf_kpoint import he2_cells, trs_dm
from torch_test_threads import two_torch_threads  # noqa: F401


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def diamond():
    """(JAX package's cell, port's cell, kpts, AO values (tensor), dm)."""
    kw = dict(basis="gth-szv", pseudo="gth-pade", ke_cutoff=50.0)
    cell_j = jax_structure.to_cell(*jax_structure.bulk_diamond(), **kw)
    cell = structure.to_cell(*structure.bulk_diamond(), **kw)
    kpts = cell.get_kpts([1, 1, 2])
    ao = eval_ao_kpts(cell, cell.gen_uniform_grids(), kpts, device="cpu")
    dm = trs_dm(cell, kpts, cell.nao_nr(), seed=2)[0]
    return cell_j, cell, kpts, ao, dm


def test_pw_jk_matches_jax(diamond):
    cell_j, cell, kpts, ao, dm = diamond
    vj_j, vk_j = jax_pw_jk.get_jk_kpts(cell_j, jnp.asarray(dm),
                                       jnp.asarray(ao.numpy()), kpts)
    vj, vk = pw_jk.get_jk_kpts(cell, dm, ao, kpts)
    assert _rel(vj.numpy(), vj_j) < 1e-10
    assert _rel(vk.numpy(), vk_j) < 1e-10


@pytest.mark.parametrize("budget_gb", [0.05, 0.01, 0.003])
def test_pw_k_blocking_exact(diamond, budget_gb):
    """Budgets that batch several k-pairs, one pair with split bra rows,
    and one row at a time give the unblocked exchange."""
    _, cell, kpts, ao, dm = diamond
    nk, ng, nao = ao.shape
    pb, rb = pw_jk._pair_plan(nk, ng, nao, budget_gb * 1e9)
    assert (pb, rb) == {0.05: (2, nao), 0.01: (1, 3),
                        0.003: (1, 1)}[budget_gb]
    ref = pw_jk.get_k_kpts(cell, dm, ao, kpts, max_memory_gb=10.0)
    vk = pw_jk.get_k_kpts(cell, dm, ao, kpts, max_memory_gb=budget_gb)
    assert _rel(vk.numpy(), ref.numpy()) < 1e-12


def test_pw_eri_matches_jax(diamond):
    cell_j, cell, kpts, ao, _ = diamond
    q = kpts[1] - kpts[0]
    aos = [ao[i] for i in (0, 1, 1, 0)]
    ref = jax_pw_eri.get_eri_from_ao(
        cell_j, [jnp.asarray(a.numpy()) for a in aos], q)
    assert _rel(pw_eri.get_eri_from_ao(cell, aos, q).numpy(), ref) < 1e-10
    coords = cell.gen_uniform_grids()
    for sign in (+1, -1):
        ref = jax_pw_eri.get_ao_pairs_G(jnp.asarray(aos[0].numpy()),
                                        jnp.asarray(aos[1].numpy()), q,
                                        coords, cell.mesh, sign=sign)
        out = pw_eri.get_ao_pairs_G(aos[0], aos[1], q, coords, cell.mesh,
                                    sign=sign)
        assert _rel(out.numpy(), ref) < 1e-10


@pytest.mark.parametrize("kmesh", [[1, 1, 2], [2, 2, 2], [4, 4, 4]])
def test_madelung_matches_jax(diamond, kmesh):
    cell_j, cell = diamond[:2]
    ref = jax_integrals.madelung(cell_j, kmesh)
    assert abs(integrals.madelung(cell, kmesh) - ref) <= 1e-12 * abs(ref)


@pytest.fixture(scope="module")
def diamond_isdf(diamond):
    cell_j, cell, kpts = diamond[:3]
    df_j = JaxISDF(cell_j, kpts, c0=10.0, m0=(9, 9, 9), verbose=0).build()
    df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build(mask=np.asarray(df_j.mask))
    return df_j, df


def test_isdf_exxdiv_ewald_matches_jax(diamond, diamond_isdf):
    _, _, kpts, _, dm = diamond
    df_j, df = diamond_isdf
    assert abs(df.madelung() - df_j.madelung()) <= 1e-12 * df_j.madelung()
    assert _rel(df.get_ovlp().numpy(), df_j.get_ovlp()) < 1e-12
    dms = np.stack([dm, trs_dm(diamond[1], kpts, dm.shape[-1], seed=7)[0]])
    vj_j, vk_j = df_j.get_jk(dms, exxdiv="ewald")
    vj, vk = df.get_jk(dms, exxdiv="ewald")
    assert _rel(vj.numpy(), vj_j) < 1e-8
    assert _rel(vk.numpy(), vk_j) < 1e-8
    _, vk0 = df.get_jk(dms)
    assert _rel(vk.numpy() - vk0.numpy(),
                np.asarray(vk_j) - np.asarray(df_j.get_jk(dms)[1])) < 1e-10


def test_isdf_get_eri_matches_jax(diamond_isdf):
    df_j, df = diamond_isdf
    for kidx in [(0, 0, 0, 0), (0, 1, 1, 0), (1, 0, 0, 1), (0, 1, 0, 1)]:
        ref = df_j.get_eri(kidx)
        assert _rel(df.get_eri(kidx).numpy(), ref) < 1e-8
    with pytest.raises(ValueError):
        df.get_eri((0, 1, 0, 0))


def test_pwdf_ewald_matches_jax(diamond):
    cell_j, cell, kpts, _, dm = diamond
    dms = np.stack([dm, dm.conj()])
    vj_j, vk_j = JaxPWDF(cell_j, kpts).get_jk(dms, exxdiv="ewald")
    vj, vk = PWDF(cell, kpts, device="cpu").get_jk(dms, exxdiv="ewald")
    assert vj.shape == dms.shape
    assert _rel(vj.numpy(), vj_j) < 1e-10
    assert _rel(vk.numpy(), vk_j) < 1e-10
    # a screened kernel has no q+G = 0 divergence to correct
    with pytest.raises(NotImplementedError):
        PWDF(cell, kpts, device="cpu").get_jk(dm, omega=0.3, exxdiv="ewald")


def test_exact_krhf_matches_jax(diamond):
    """KRHF with no provider runs on a PWDF, with exxdiv passed through."""
    cell_j, cell, kpts = diamond[:3]
    kw = dict(verbose=0, conv_tol=1e-10, exxdiv="ewald")
    e_j = JaxKRHF(cell_j, kpts, **kw).kernel()
    mf = KRHF(cell, kpts, device="cpu", **kw)
    assert isinstance(mf.with_df, PWDF)
    assert abs(mf.kernel() - e_j) < 1e-8 and mf.converged


def test_full_rank_isdf_matches_port_oracle():
    """A full-rank fit on He2 serves the port's own exact J/K to
    test_full_rank_jk_exact's 1e-9."""
    _, cell = he2_cells()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=50.0, m0=tuple(cell.mesh), verbose=0,
                 select_tol=1e-20, rcond=1e-13, device="cpu").build()
    dm = trs_dm(cell, kpts, 2)[0]
    vj_ref, vk_ref = PWDF(cell, kpts, device="cpu").get_jk(dm)
    vj, vk = df.get_jk(dm)
    assert np.abs((vj - vj_ref).numpy()).max() < 1e-9
    assert np.abs((vk - vk_ref).numpy()).max() < 1e-9
