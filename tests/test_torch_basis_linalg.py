"""PyTorch port against the JAX package: AO evaluation and linalg.

Same seeded numpy inputs through both packages on the CPU in f64; each
package gets its own cell, built by its own Cell from the same arguments.
Tolerances: 1e-12 for evaluation, FFTs and the Coulomb kernel (f64
roundoff of the same formulas); identical pivots and rank for the pivoted
Cholesky on a matrix whose pivots are well separated; 1e-10 relative for
the ridge operators (the solve amplifies roundoff by up to cond ~ 1/rcond
times eps on the scaled matrix).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.basis.eval import eval_ao_kpts as jax_eval, make_evaluator
from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.linalg import coulomb as jax_coulomb
from fftisdf_tpu.linalg import fft as jax_fft
from fftisdf_tpu.linalg.pivoted_cholesky import (
    pivoted_cholesky as jax_pivoted_cholesky)
from fftisdf_tpu.linalg import solvers as jax_solvers
from jax_records import recorded
from fftisdf_tpu_torch.basis import eval as t_eval
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.linalg import coulomb as t_coulomb
from fftisdf_tpu_torch.linalg import fft as t_fft
from fftisdf_tpu_torch.linalg import pivoted_cholesky as t_pc
from fftisdf_tpu_torch.linalg import solvers as t_solvers


def he2_cells():
    """(JAX package's cell, port's cell) from the same arguments."""
    kw = dict(a=np.diag([5.0, 5.0, 7.0]),
              atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
              basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 21]),
              unit="bohr", precision=1e-12)
    return JaxCell(**kw).build(), Cell(**kw).build()


def diamond_cells():
    kw = dict(basis="gth-szv", pseudo="gth-pade", ke_cutoff=50.0)
    return (jax_structure.to_cell(*jax_structure.bulk_diamond(), **kw),
            structure.to_cell(*structure.bulk_diamond(), **kw))


@pytest.mark.parametrize("make_cells,kmesh", [(he2_cells, [1, 1, 2]),
                                              (diamond_cells, [1, 1, 2])])
def test_make_evaluator_matches_jax(make_cells, kmesh):
    cell_j, cell = make_cells()
    kpts = cell.get_kpts(kmesh)
    coords = cell.gen_uniform_grids()
    ref = np.asarray(jax_eval(cell_j, coords, kpts))
    out = t_eval.make_evaluator(cell, kpts=kpts, device="cpu")(coords)
    assert out.dtype == torch.complex128 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-12, rtol=0)


def test_evaluator_blocks_and_off_cell_points():
    """Grid-blocked evaluation equals one block, and points outside the
    home cell carry the Bloch phase (gamma evaluator included)."""
    cell_j, cell = diamond_cells()
    kpts = cell.get_kpts([1, 2, 1])
    rng = np.random.default_rng(3)
    coords = rng.uniform(-8.0, 8.0, size=(500, 3))
    fn = t_eval.make_evaluator(cell, kpts=kpts, device="cpu")
    whole = fn(coords)
    fn.block_size = lambda ng: 64
    np.testing.assert_allclose(fn(coords).numpy(), whole.numpy(),
                               atol=1e-14, rtol=0)
    np.testing.assert_allclose(
        whole.numpy(), np.asarray(jax_eval(cell_j, coords, kpts)), atol=1e-12,
        rtol=0)
    gam = t_eval.make_evaluator(cell, device="cpu")(coords)
    ref = np.asarray(make_evaluator(cell_j)(jnp.asarray(coords)))
    np.testing.assert_allclose(gam.numpy(), ref, atol=1e-12, rtol=0)


def test_face_points_wrap_alike_on_either_side(monkeypatch):
    """A point on a face or corner of the home cell, computed an ulp to
    either side of it, wraps to the same home-cell point: the two sides'
    AO values agree to roundoff (1.1e-14 here).  The floor of the raw
    fractional coordinate (WRAP_EPS 0) moves one of them by a lattice
    vector and changes its image sum by 1.5e-12 at the corner, above the
    card tests' 1e-12 (the card and the CPU round such points to
    different sides)."""
    _, cell = diamond_cells()
    kpts = cell.get_kpts([1, 1, 2])
    on = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 4 / 9], [0.0, 0.5, 0.0]])
    below = np.where(on == 0.0, -1e-15, on)
    fn = t_eval.make_evaluator(cell, kpts=kpts, device="cpu")
    a = np.asarray(cell.a)
    np.testing.assert_allclose(fn(below @ a).numpy(), fn(on @ a).numpy(),
                               atol=1e-13, rtol=0)
    monkeypatch.setattr(t_eval, "WRAP_EPS", 0.0)
    raw = np.abs(fn(below @ a).numpy() - fn(on @ a).numpy()).max()
    assert raw > 1e-12, raw


def test_fft3_matches_jax():
    rng = np.random.default_rng(1)
    mesh = (6, 5, 7)
    f = rng.standard_normal((3, 210)) + 1j * rng.standard_normal((3, 210))
    for jfn, tfn in ((jax_fft.fft3, t_fft.fft3),
                     (jax_fft.ifft3, t_fft.ifft3)):
        ref = np.asarray(jfn(jnp.asarray(f), mesh))
        out = tfn(torch.from_numpy(f), mesh).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)


def test_coulG_batched_matches_jax():
    cell_j, cell = diamond_cells()
    kpts = cell.get_kpts([2, 1, 2])
    gv = cell.get_Gv()
    ref = np.asarray(jax_coulomb.get_coulG_batched(cell_j, kpts, gv))
    out = t_coulomb.get_coulG_batched(
        cell, torch.from_numpy(kpts), torch.from_numpy(gv))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-12, rtol=1e-12)
    # a screened truncated kernel is refused, as in the JAX package
    with pytest.raises(NotImplementedError):
        t_coulomb.get_coulG_batched(cell, torch.from_numpy(kpts),
                                    torch.from_numpy(gv), omega=0.3,
                                    trunc=("0d", 3.0))


def test_pivoted_cholesky_matches_jax():
    """Seeded PSD matrix of rank 12 whose greedy pivots are well
    separated: identical pivots, rank, Schur diagonals and factor."""
    rng = np.random.default_rng(7)
    n, r = 40, 12
    b = rng.standard_normal((r, n)) * np.geomspace(1.0, 1e-3, n)[None, :]
    a = b.T @ b
    L_j, piv_j, rank_j, hist_j = jax_pivoted_cholesky(jnp.asarray(a),
                                                      max_rank=20)
    L_t, piv_t, rank_t, hist_t = t_pc.pivoted_cholesky(torch.from_numpy(a),
                                                       max_rank=20)
    assert rank_t == int(rank_j) == r
    np.testing.assert_array_equal(piv_t.numpy()[:r], np.asarray(piv_j)[:r])
    np.testing.assert_allclose(hist_t.numpy()[:r], np.asarray(hist_j)[:r],
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(L_t.numpy()[:r], np.asarray(L_j)[:r],
                               atol=1e-10, rtol=0)


def _fit_matrix(n=24, m=60, seed=5):
    """Hermitian PSD normal matrix with a decaying spectrum, and a RHS."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    z *= np.geomspace(1.0, 1e-4, n)[:, None]
    b = rng.standard_normal((n, 9)) + 1j * rng.standard_normal((n, 9))
    return z @ z.conj().T, b


@pytest.mark.parametrize("refine", [0, 2])
def test_ridge_half_operator_matches_jax(refine):
    a, b = _fit_matrix()
    m_in = b @ b.conj().T

    def jax_side():
        half_j, finish_j, _ = jax_solvers.fitting_half_operator(
            jnp.asarray(a), method="ridge", rcond=1e-10, refine=refine)
        return half_j(jnp.asarray(b)), finish_j(jnp.asarray(m_in))

    g_ref, w_ref = recorded(f"basis_linalg/ridge_half/{refine}", jax_side)
    half_t, finish_t, rank = t_solvers.fitting_half_operator(
        torch.from_numpy(a), method="ridge", rcond=1e-10, refine=refine)
    assert rank == a.shape[0]
    g = half_t(torch.from_numpy(b)).numpy()
    assert abs(g - g_ref).max() < 1e-10 * abs(g_ref).max()
    w = finish_t(torch.from_numpy(m_in)).numpy()
    assert abs(w - w_ref).max() < 1e-10 * abs(w_ref).max()
    # S M S with M = b b^H through the split form, finish((H b)(H b)^H),
    # equals the full operator applied on both sides
    apply_t, _ = t_solvers.ridge_operator(torch.from_numpy(a), rcond=1e-10,
                                          refine=refine)
    sms = apply_t(apply_t(torch.from_numpy(m_in)).mH).mH
    sms = sms.resolve_conj().numpy()
    g_t = torch.from_numpy(g)
    w_split = finish_t(g_t @ g_t.mH).numpy()
    assert abs(w_split - sms).max() < 1e-8 * abs(sms).max()
    # grid-major half apply equals the row form
    rows = t_solvers.half_apply_rows(
        t_solvers.half_factor_data(torch.from_numpy(a), refine=refine),
        torch.from_numpy(b.T.copy()))
    np.testing.assert_allclose(rows.numpy().T, g, atol=1e-12 * abs(g).max())
    with pytest.raises(ValueError):
        t_solvers.fitting_half_operator(torch.from_numpy(a), method="qr")


def test_ridge_operator_matches_jax():
    a, b = _fit_matrix(seed=9)
    apply_j, _ = jax_solvers.ridge_operator(jnp.asarray(a), rcond=1e-10)
    apply_t, _ = t_solvers.ridge_operator(torch.from_numpy(a), rcond=1e-10)
    ref = np.asarray(apply_j(jnp.asarray(b)))
    out = apply_t(torch.from_numpy(b)).numpy()
    assert abs(out - ref).max() < 1e-10 * abs(ref).max()
