"""PyTorch port of the k-point ISDF build and J/K serve against the JAX
package, on the He2 fixture of tests/test_isdf_kpoint.py (CPU, f64).

Selection on this cell meets exact ties between mirror-equivalent grid
points, which the two packages break by their own roundoff; selection is
compared there by what the tie-break leaves unchanged (nip, rank, the
pivot residuals, the fit), and the mask itself on a cell without mirror
symmetry.  Raw w_q is not
compared: it is noise-limited in near-null fit directions; served J/K are.
Each package gets its own cell, built by its own Cell from the same
arguments.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.isdf import FFTISDF as JaxISDF
from fftisdf_tpu.isdf import jk as jax_jk
from fftisdf_tpu.isdf.kpoint import (
    select_interpolation_points as jax_select, _sector_wq as jax_sector_wq)
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.lattice import kpoints as kpt_mod
from fftisdf_tpu.pw import get_jk_kpts
from fftisdf_tpu_torch.basis.eval import eval_ao_kpts
from fftisdf_tpu_torch.isdf import FFTISDF, jk as t_jk, kpoint as t_kp
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.utils.serialization import load_isdf_state
from torch_test_threads import two_torch_threads  # noqa: F401


def he2_cells(asymmetric=False):
    """(JAX package's cell, port's cell) from the same arguments."""
    atoms = ([("He", (2.1, 2.6, 2.0)), ("He", (2.7, 2.3, 4.4))]
             if asymmetric else
             [("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))])
    kw = dict(a=np.diag([5.0, 5.0, 7.0]), atom=atoms, basis="sto-3g",
              pseudo=None, mesh=np.array([15, 15, 21]), unit="bohr",
              precision=1e-12)
    return JaxCell(**kw).build(), Cell(**kw).build()


@pytest.fixture(scope="module")
def he2():
    """(JAX package's cell, port's cell, kpts)."""
    cell_j, cell = he2_cells()
    return cell_j, cell, cell.get_kpts([1, 1, 2])


def trs_dm(cell, kpts, nao, seed=0, nset=1):
    """Random hermitian densities with dm[-k] = conj(dm[k])."""
    rng = np.random.default_rng(seed)
    nk = len(kpts)
    s = cell.get_scaled_kpts(kpts)
    dm = rng.standard_normal((nset, nk, nao, nao)) \
        + 1j * rng.standard_normal((nset, nk, nao, nao))
    dm = dm + dm.conj().transpose(0, 1, 3, 2)
    for k in range(nk):
        km = kpt_mod.member(-s[k], s)
        if km < k:
            continue
        avg = (dm[:, k] + dm[:, km].conj()) / 2
        dm[:, k] = avg
        dm[:, km] = avg.conj()
    return dm


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def he2_compressed(he2):
    cell_j, cell, kpts = he2
    kw = dict(c0=10.0, m0=(9, 9, 13), verbose=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (JaxISDF(cell_j, kpts, **kw).build(),
                FFTISDF(cell, kpts, device="cpu", **kw).build())


def _pivot_residuals(cell_j, cell, kpts, m0, max_rank):
    """The Schur diagonal at each pivot of each package's selection gram
    on the parent mesh ``m0``: the JAX package's CPU gram
    (Re sum_k X_k X_k^H)^2 / nk through its pivoted Cholesky, and the
    port's K1 gram through the port's."""
    from fftisdf_tpu.basis.eval import make_evaluator as jax_evaluator
    from fftisdf_tpu.linalg.pivoted_cholesky import (
        pivoted_cholesky as jax_pivoted_cholesky)
    from fftisdf_tpu_torch.basis.eval import make_evaluator
    from fftisdf_tpu_torch.linalg.pivoted_cholesky import pivoted_cholesky
    from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq

    coords0 = cell.gen_uniform_grids(m0)
    nk = len(kpts)
    x0 = jax_evaluator(cell_j, kpts=kpts)(jnp.asarray(coords0))
    x2 = jnp.einsum("kgm,khm->gh", x0.conj(), x0).real
    hist_j = jax_pivoted_cholesky(x2 * x2 / nk, max_rank=max_rank)[3]
    x0_t = make_evaluator(cell, kpts=kpts, device="cpu")(coords0)
    hist_t = pivoted_cholesky(pair_gram_sq(x0_t, square=False) * nk,
                              max_rank=max_rank)[3]
    return np.asarray(hist_j), hist_t.numpy()


def test_selection_matches_jax(he2, he2_compressed):
    """Selection at test_compressed_eri_gate's config, held by what the
    tie-breaking between mirror-equivalent points leaves unchanged: nip
    and rank, the pivot residual at every pivot, and the fit served from
    each package's own interpolation points."""
    cell_j, cell, kpts = he2
    df_j, df_t = he2_compressed
    assert df_t.nip == df_j.nip
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, _, r_j, _ = jax_select(cell_j, kpts, (9, 9, 13), 10.0)
        _, _, r_t, _ = t_kp.select_interpolation_points(
            cell, kpts, (9, 9, 13), 10.0, device="cpu")
    assert r_t == int(r_j)
    hist_j, hist_t = _pivot_residuals(cell_j, cell, kpts, (9, 9, 13),
                                      df_j.nip)
    np.testing.assert_allclose(hist_t, hist_j, rtol=0,
                               atol=1e-10 * hist_j[0])
    dm = trs_dm(cell, kpts, 2, seed=9, nset=2)
    vj_j, vk_j = df_j.get_jk(dm)
    vj_t, vk_t = df_t.get_jk(dm)
    assert _rel(vj_t, vj_j) < 1e-8
    assert _rel(vk_t, vk_j) < 1e-8


def test_selection_mask_identical_without_ties():
    """On a He2 cell without mirror symmetry the pivots are not tied and
    the mask is identical to the JAX package's, with x_k to 1e-12."""
    cell_j, cell = he2_cells(asymmetric=True)
    kpts = cell.get_kpts([1, 1, 2])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x_j, m_j, r_j, _ = jax_select(cell_j, kpts, (9, 9, 13), 10.0)
        x_t, m_t, r_t, _ = t_kp.select_interpolation_points(
            cell, kpts, (9, 9, 13), 10.0, device="cpu")
    assert r_t == int(r_j)
    np.testing.assert_array_equal(m_t, np.asarray(m_j))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-12,
                               rtol=0)


def test_pool_saturation_warning(he2):
    _, cell, kpts = he2
    with pytest.warns(t_kp.PoolSaturationWarning):
        t_kp.select_interpolation_points(cell, kpts, (3, 3, 4), 10.0,
                                         device="cpu")


def test_compressed_jk_matches_jax(he2, he2_compressed):
    _, cell, kpts = he2
    df_j, df_t = he2_compressed
    dm = trs_dm(cell, kpts, 2, nset=2)
    vj_j, vk_j = df_j.get_jk(dm)
    vj_t, vk_t = df_t.get_jk(dm)
    assert _rel(vj_t, vj_j) < 1e-8
    assert _rel(vk_t, vk_j) < 1e-8
    # single density: no set axis
    vj1, vk1 = df_t.get_jk(dm[0])
    np.testing.assert_allclose(vj1.numpy(), vj_t[0].numpy(), atol=1e-14)
    with pytest.raises(NotImplementedError):
        df_t.get_jk(dm[0], exxdiv="gygi")


def test_full_rank_jk_exact(he2):
    """Full-rank fit (he2_isdf_full's config) reproduces the exact
    plane-wave J/K of the JAX package to test_full_rank_jk_exact's 1e-9."""
    cell_j, cell, kpts = he2
    df = FFTISDF(cell, kpts, c0=50.0, m0=tuple(cell.mesh), verbose=0,
                 select_tol=1e-20, rcond=1e-13, device="cpu").build()
    ao = eval_ao_kpts(cell, cell.gen_uniform_grids(), kpts,
                      device="cpu").numpy()
    dm = trs_dm(cell, kpts, 2)[0]
    vj_ref, vk_ref = get_jk_kpts(cell_j, jnp.asarray(dm), jnp.asarray(ao),
                                 kpts)
    vj, vk = df.get_jk(dm)
    assert np.abs(vj.numpy() - np.asarray(vj_ref)).max() < 1e-9
    assert np.abs(vk.numpy() - np.asarray(vk_ref)).max() < 1e-9


def test_state_carried_across(tmp_path, he2, he2_compressed):
    """JAX builds and saves; the port loads and serves the same J/K; the
    port's own state round-trips through the same format."""
    cell_j, cell, kpts = he2
    df_j, df_t = he2_compressed
    path = tmp_path / "jax_state.npz"
    df_j.save(path)
    df_l = load_isdf_state(path, cell, kpts, device="cpu")
    np.testing.assert_array_equal(df_l.mask, np.asarray(df_j.mask))
    dm = trs_dm(cell, kpts, 2, seed=4)[0]
    vj_j, vk_j = df_j.get_jk(dm)
    vj_l, vk_l = df_l.get_jk(dm)
    assert _rel(vj_l, vj_j) < 1e-12
    assert _rel(vk_l, vk_j) < 1e-12
    path2 = tmp_path / "torch_state.npz"
    df_t.save(path2)
    df_b = JaxISDF.load(path2, cell_j, kpts)
    vj_b, vk_b = df_b.get_jk(dm)
    vj_t, vk_t = df_t.get_jk(dm)
    assert _rel(vj_t, vj_b) < 1e-12
    assert _rel(vk_t, vk_b) < 1e-12
    with pytest.raises(ValueError):
        load_isdf_state(path, cell, cell.get_kpts([1, 1, 3]), device="cpu")


def test_k_serve_img_matches_phase(he2):
    """The image-space K serve equals the plain phase-matrix algebra on a
    1x3x2 mesh, and matches the JAX package's serve."""
    _, cell, _ = he2
    kpts6 = cell.get_kpts([1, 3, 2])
    df = FFTISDF(cell, kpts6, c0=8.0, m0=(9, 9, 13), verbose=0,
                 device="cpu").build()
    dm = torch.from_numpy(trs_dm(cell, kpts6, 2, nset=2))
    phase = torch.as_tensor(df.phase)
    vk_phase = t_jk.get_k_kpts(df.x_k, df.wq, phase, dm)
    ws = t_jk.wq_to_ws(df.wq, df.kmesh)
    ws_ref = np.einsum("Rq,qIJ->RIJ", df.phase, df.wq.numpy()).real \
        * np.sqrt(len(kpts6))
    np.testing.assert_allclose(ws.numpy(), ws_ref, atol=1e-10)
    vk_img = t_jk.get_k_kpts_img(df.x_k, ws, dm, df.kmesh)
    assert _rel(vk_img, vk_phase) < 1e-12
    vk_jax = jax_jk.get_k_kpts_img(jnp.asarray(df.x_k.numpy()),
                                   jnp.asarray(ws.numpy()),
                                   jnp.asarray(dm.numpy()),
                                   tuple(int(m) for m in df.kmesh))
    assert _rel(vk_img, vk_jax) < 1e-12


def test_sector_wq_matches_jax(he2):
    """One sector's metric: the grid-major slab form against the JAX
    package's _sector_wq on the same seeded RHS."""
    _, cell, kpts = he2
    rng = np.random.default_rng(11)
    nip, ngrid = 9, int(np.prod(cell.mesh))
    z = rng.standard_normal((nip, 40)) + 1j * rng.standard_normal((nip, 40))
    x4 = z @ z.conj().T
    y = rng.standard_normal((ngrid, nip)) + 1j * rng.standard_normal(
        (ngrid, nip))
    q = kpts[1]
    gv = cell.get_Gv() + q[None, :]
    g2 = np.einsum("gi,gi->g", gv, gv)
    coulG = np.where(g2 > 1e-12, 4 * np.pi / np.where(g2 > 1e-12, g2, 1), 0)
    eiqr = np.exp(1j * cell.gen_uniform_grids() @ q)
    mesh, vol = tuple(int(m) for m in cell.mesh), float(cell.vol)
    ref, _ = jax_sector_wq(jnp.asarray(x4), jnp.asarray(y),
                           jnp.asarray(coulG), jnp.asarray(eiqr), mesh, vol,
                           ngrid, solver="ridge", rcond=1e-10, refine=0)
    t = torch.from_numpy
    out = t_kp._sector_wq(t(x4), t(y.copy()), t(coulG), t(eiqr), mesh, vol,
                          col_block=4)
    oracle = t_kp._sector_wq_reference(t(x4), t(y), t(coulG), t(eiqr), mesh,
                                       vol)
    assert _rel(out, ref) < 1e-10
    assert _rel(oracle, ref) < 1e-10


def test_chunked_build_matches_single_chunk(he2):
    """A byte budget that forces one sector per chunk and small grid
    blocks reproduces the single-chunk build (1x1x3: a conjugate pair)."""
    _, cell, _ = he2
    kpts3 = cell.get_kpts([1, 1, 3])
    kw = dict(c0=8.0, m0=(9, 9, 13), verbose=0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df1 = FFTISDF(cell, kpts3, **kw).build()
        plane_gb = np.prod(cell.mesh) * df1.nip * 16 / 1e9
        df2 = FFTISDF(cell, kpts3, max_memory_gb=2.5 * plane_gb,
                      **kw).build()
    assert df1.nchunks == 1 and df2.nchunks == 2
    dm = trs_dm(cell, kpts3, 2)[0]
    vj1, vk1 = df1.get_jk(dm)
    vj2, vk2 = df2.get_jk(dm)
    assert _rel(vj2, vj1) < 1e-10
    assert _rel(vk2, vk1) < 1e-10


def test_unported_options_raise(he2, he2_compressed):
    """What stays refused is what the JAX package refuses: exxdiv with a
    screened kernel, omega with band k-points, and exxdiv with band
    k-points (the SCF layer applies that correction at mesh points).  Band
    k-points and exxdiv with a truncated kernel are served; m0='auto' and
    the eigh-family solvers are accepted; an unknown solver is a
    ValueError."""
    _, cell, kpts = he2
    df = he2_compressed[1]
    dm = trs_dm(cell, kpts, 2)[0]
    with pytest.raises(NotImplementedError):
        df.get_jk(dm, omega=0.5, exxdiv="ewald")
    with pytest.raises(NotImplementedError):
        df.get_jk(dm, omega=0.5, kpts_band=kpts[:1])
    with pytest.raises(NotImplementedError):
        df.get_jk(dm, exxdiv="ewald", kpts_band=kpts[:1])
    vj_b, vk_b = df.get_jk(dm, kpts_band=kpts[:1])
    assert vj_b.shape == vk_b.shape == (1, 2, 2)
    df_t = FFTISDF(cell, kpts, m0=(9, 9, 13), trunc="0d", device="cpu")
    df_t.x_k, df_t.wq = df.x_k, df.wq
    _, vk0 = df_t.get_jk(dm)
    _, vk1 = df_t.get_jk(dm, exxdiv="ewald")
    assert df_t.madelung() == 0.0
    assert float((vk1 - vk0).abs().max()) == 0.0
    assert FFTISDF(cell, kpts, m0="auto", device="cpu").m0 == (15, 15, 15)
    assert FFTISDF(cell, kpts, solver="lstsq", device="cpu").solver == "lstsq"
    with pytest.raises(ValueError):
        FFTISDF(cell, kpts, solver="qr", device="cpu")
