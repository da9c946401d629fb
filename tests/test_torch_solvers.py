"""PyTorch port against the JAX package: the fitting solvers of the eigh
family and the selection factorisations.

The same seeded numpy matrices go through ``fftisdf_tpu.linalg`` and the
port's on the CPU.  Tolerances: 1e-10 relative in f64 for every solver on a
well-conditioned matrix (one eigh or Cholesky of the same matrix; LAPACK's
roundoff times the condition number); the JAX tests' own bounds for the
split-operator identity (3e-7 of the scale, tests/test_linalg.py) and for
the float32 indefinite gram (finite factor, 5e-2 on the healthy subspace);
identical pivots for the factorisations on matrices without ties.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.linalg import solvers as jax_solvers
from jax_records import recorded
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.linalg import pivoted_cholesky as t_pc
from fftisdf_tpu_torch.linalg import solvers as t_solvers
from fftisdf_tpu_torch.ops.pair_gram import pair_gram_sq

# (fftisdf_tpu.linalg exports a function of the module's name)
jax_pc = importlib.import_module("fftisdf_tpu.linalg.pivoted_cholesky")
METHODS = ["ridge", "lstsq", "pinv", "svd"]
t = torch.from_numpy


def random_psd(n, r, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, r)) + 1j * rng.standard_normal((n, r))
    return b @ b.conj().T


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("method", METHODS)
def test_solve_fitting_matches_jax(method):
    """Full-rank system: the solution and rank of each method, 1e-10."""
    rng = np.random.default_rng(2)
    a = random_psd(20, 20)
    b = rng.standard_normal((20, 7)) + 1j * rng.standard_normal((20, 7))
    z_j, r_j = recorded(f"solvers/full_rank/{method}",
                        lambda: jax_solvers.solve_fitting(
                            jnp.asarray(a), jnp.asarray(b), method=method))
    z, r = t_solvers.solve_fitting(t(a), t(b), method=method)
    assert r == int(r_j) == 20
    assert _rel(z.numpy(), z_j) < 1e-10
    np.testing.assert_allclose(z.numpy(), np.linalg.solve(a, b), atol=1e-8)


def test_solve_fitting_singular_matches_jax():
    """Rank-deficient system (rank 6 of 15): ranks, residual-consistent
    solutions, and the unpreconditioned eigh solve equal to the svd one,
    as tests/test_linalg.py::test_solve_fitting_singular; the solutions
    against the JAX package's to 1e-8 (minimum-norm, cond ~1e3)."""
    a = random_psd(15, 6)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((15, 2)) + 1j * rng.standard_normal((15, 2))
    b = a @ x0
    for kw in (dict(method="lstsq", precondition=False),
               dict(method="lstsq"), dict(method="svd"),
               dict(method="pinv", rank=4)):
        z_j, r_j = recorded(
            "solvers/singular/" + "/".join(f"{k}={v}" for k, v in kw.items()),
            lambda: jax_solvers.solve_fitting(jnp.asarray(a), jnp.asarray(b),
                                              rcond=1e-10, **kw))
        z, r = t_solvers.solve_fitting(t(a), t(b), rcond=1e-10, **kw)
        assert r == int(r_j) == (4 if "rank" in kw else 6)
        assert _rel(z.numpy(), z_j) < 1e-8, kw
        if "rank" not in kw:
            np.testing.assert_allclose(a @ z.numpy(), b, atol=1e-8)
    z_h, r_h = t_solvers.hermitian_solve(t(a), t(b), rcond=1e-10)
    z_hj, _ = recorded("solvers/singular/hermitian",
                       lambda: jax_solvers.hermitian_solve(
                           jnp.asarray(a), jnp.asarray(b), rcond=1e-10))
    assert r_h == 6 and _rel(z_h.numpy(), z_hj) < 1e-8
    z_r, _ = t_solvers.ridge_solve(t(a + np.eye(15)), t(b))
    z_rj, _ = recorded("solvers/singular/ridge",
                       lambda: jax_solvers.ridge_solve(
                           jnp.asarray(a + np.eye(15)), jnp.asarray(b)))
    assert _rel(z_r.numpy(), z_rj) < 1e-10


@pytest.mark.parametrize("method,refine", [("ridge", 0), ("ridge", 1),
                                           ("ridge", 2), ("lstsq", 0),
                                           ("pinv", 0), ("svd", 0)])
def test_fitting_half_operator_identity(method, refine):
    """w = S (B K B^H) S through the split operator equals the
    solve-then-contract path z = S B, w = z K z^H on an ill-conditioned
    matrix (cond 1e12), to the JAX test's 3e-7 of the scale; half and
    finish against the JAX package's to the same bound; the grid-major
    half apply equals the row form."""
    rng = np.random.default_rng(0)
    n, m = 40, 90
    x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    u = np.linalg.qr(x)[0]
    a = (u * 10.0 ** rng.uniform(-12, 0, n)) @ u.conj().T
    b = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    kdiag = rng.uniform(0, 2, m)
    ap, rk = t_solvers.fitting_operator(t(a), method=method, rcond=1e-8,
                                        refine=refine)
    z = ap(t(b)).numpy()
    w_ref = (z * kdiag) @ z.conj().T
    half, finish, rk2 = t_solvers.fitting_half_operator(
        t(a), method=method, rcond=1e-8, refine=refine)
    g = half(t(b)).numpy()
    m_in = (g * kdiag) @ g.conj().T
    w_new = finish(t(m_in)).numpy()
    scale = abs(w_ref).max()
    assert abs(w_new - w_ref).max() < 3e-7 * scale
    assert rk == rk2

    def jax_side():
        half_j, finish_j, rk_j = jax_solvers.fitting_half_operator(
            jnp.asarray(a), method=method, rcond=1e-8, refine=refine)
        w_j = np.asarray(finish_j(jnp.asarray(
            (np.asarray(half_j(jnp.asarray(b))) * kdiag)
            @ np.asarray(half_j(jnp.asarray(b))).conj().T)))
        return rk_j, w_j

    rk_j, w_j = recorded(f"solvers/half_operator/{method}/{refine}",
                         jax_side)
    assert rk2 == int(rk_j)
    assert abs(w_new - w_j).max() < 3e-7 * scale
    data = t_solvers.half_factor_data(t(a), method=method, rcond=1e-8,
                                      refine=refine)
    rows = t_solvers.half_apply_rows(data, t(b.T.copy()))
    np.testing.assert_allclose(rows.numpy().T, g, atol=1e-10 * abs(g).max())


def test_default_refine_and_rcond_follow_dtype():
    a64 = t(random_psd(6, 6))
    assert t_solvers._default_refine(a64, None) == 0
    assert t_solvers._default_refine(a64.to(torch.complex64), None) == 1
    assert t_solvers._default_refine(a64, 3) == 3
    with pytest.raises(ValueError):
        t_solvers.solve_fitting(a64, a64, method="qr")


def test_ridge_factor_survives_indefinite_f32_gram():
    """A complex64 gram whose lowest eigenvalue sits below -rcond factors
    finitely through the lambda escalation and keeps the solve on the
    healthy subspace (tests/test_linalg.py's 5e-2); the escalated solution
    agrees with the JAX package's to 2e-2 of its scale (both float32; the
    noise direction carries ~|b|/lam)."""
    rng = np.random.default_rng(7)
    n = 48
    q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + 1j * rng.standard_normal((n, n)))
    w = np.linspace(0.3, 2.0, n)
    w[0] = -3e-5
    a = (q * w) @ q.conj().T
    a32 = ((a + a.conj().T) / 2).astype(np.complex64)
    data = t_solvers.half_factor_data(t(a32), method="ridge", rcond=1e-5,
                                      refine=2)
    assert data[0] == "ridge" and bool(torch.isfinite(
        torch.view_as_real(data[2])).all())
    b = (rng.standard_normal((n, 3))
         + 1j * rng.standard_normal((n, 3))).astype(np.complex64)
    z, _ = t_solvers.solve_fitting(t(a32), t(b), method="ridge", rcond=1e-5)
    assert z.dtype == torch.complex64
    res = a32 @ z.numpy() - b
    res_h = (q[:, 1:] @ q[:, 1:].conj().T) @ res
    assert np.abs(res_h).max() < 5e-2
    z_j, _ = recorded("solvers/indefinite_f32",
                      lambda: jax_solvers.solve_fitting(
                          jnp.asarray(a32), jnp.asarray(b), method="ridge",
                          rcond=1e-5))
    assert _rel(z.numpy(), z_j) < 2e-2


@pytest.mark.parametrize("method", ["lstsq", "svd"])
def test_eigh_family_f32_matches_jax(method):
    """complex64, rcond 1e-5 on a spectrum spanning 1e-3: solutions agree
    with the JAX package's to 1e-3 relative (float32 eigh of the same
    matrix, amplified by 1/w_min ~ 1e3)."""
    rng = np.random.default_rng(5)
    n = 24
    z0 = rng.standard_normal((n, 60)) + 1j * rng.standard_normal((n, 60))
    z0 *= np.geomspace(1.0, 3e-2, n)[:, None]
    a = (z0 @ z0.conj().T).astype(np.complex64)
    b = (rng.standard_normal((n, 5))
         + 1j * rng.standard_normal((n, 5))).astype(np.complex64)
    z_j, r_j = recorded(f"solvers/eigh_f32/{method}",
                        lambda: jax_solvers.solve_fitting(
                            jnp.asarray(a), jnp.asarray(b), method=method,
                            rcond=1e-5))
    z, r = t_solvers.solve_fitting(t(a), t(b), method=method, rcond=1e-5)
    assert z.dtype == torch.complex64 and r == int(r_j)
    assert _rel(z.numpy(), z_j) < 1e-3


# ------------------------------------------------------------ factorisations
def _separated_psd(n=40, r=12, seed=7):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((r, n)) * np.geomspace(1.0, 1e-3, n)[None, :]
    return b.T @ b


def test_pivoted_cholesky_np_matches_jax():
    a = _separated_psd()
    L_j, p_j, r_j, h_j = jax_pc.pivoted_cholesky_np(a, max_rank=20)
    L_t, p_t, r_t, h_t = t_pc.pivoted_cholesky_np(a, max_rank=20)
    assert r_t == r_j
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(h_t, h_j)
    np.testing.assert_array_equal(L_t, L_j)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pivot_selection_matches_jax(dtype):
    """pivot_selection takes max_rank distinct pivots, continuing past the
    floating-point rank (rank 12, 25 pivots asked).  The pivots above the
    rank are the JAX package's; past it both hand out distinct points."""
    a = _separated_psd().astype(dtype)
    p_j, r_j, h_j = recorded(
        f"solvers/pivot_selection/{np.dtype(dtype).name}",
        lambda: jax_pc.pivot_selection(jnp.asarray(a), max_rank=25,
                                       tol=1e-6 * a.max()))
    p_t, r_t, h_t = t_pc.pivot_selection(t(a), max_rank=25,
                                         tol=1e-6 * a.max())
    p_t = p_t.numpy()
    r = int(r_j)
    assert r_t == r
    np.testing.assert_array_equal(p_t[:r], np.asarray(p_j)[:r])
    np.testing.assert_allclose(h_t.numpy()[:r], np.asarray(h_j)[:r],
                               rtol=1e-10 if dtype == np.float64 else 1e-3)
    assert len(set(p_t.tolist())) == 25 and (p_t >= 0).all()
    assert len(set(np.asarray(p_j).tolist())) == 25
    # the rank-revealing form stops emitting pivots at exhaustion
    _, p_c, r_c, _ = t_pc.pivoted_cholesky(t(_separated_psd()), max_rank=25)
    assert r_c == 12 and (p_c.numpy()[:12] >= 0).all()


def test_pivoted_cholesky_pairgram_matrix_free():
    """The matrix-free blocked factorisation gives the dense greedy
    algorithm's pivot sequence, rank and Schur-diagonal history (no ties
    in a random problem), also on a rank-deficient pair gram, and equals
    the JAX package's numpy version."""
    rng = np.random.default_rng(7)
    ng0, ncol, nk = 500, 40, 4
    flat = (rng.standard_normal((ng0, ncol))
            + 1j * rng.standard_normal((ng0, ncol)))
    x2 = (flat @ flat.conj().T).real
    x4 = x2 * x2 / nk
    for k in (60, 300):
        _, piv_d, rank_d, hist_d = t_pc.pivoted_cholesky_np(x4, max_rank=k)
        piv_m, rank_m, hist_m = t_pc.pivoted_cholesky_pairgram(
            t(flat), nk, k, block=29)
        piv_j, rank_j, hist_j = jax_pc.pivoted_cholesky_pairgram_np(
            flat, nk, k, block=29)
        np.testing.assert_array_equal(piv_m, piv_d)
        np.testing.assert_array_equal(piv_m, piv_j)
        assert rank_d == rank_m == rank_j
        np.testing.assert_allclose(hist_m, hist_d, rtol=1e-10,
                                   atol=1e-12 * hist_d.max())
        np.testing.assert_allclose(hist_m, hist_j, rtol=1e-10,
                                   atol=1e-12 * hist_d.max())
    u = rng.standard_normal((ng0, 7)) + 1j * rng.standard_normal((ng0, 7))
    x2l = (u @ u.conj().T).real
    _, piv_d, rank_d, _ = t_pc.pivoted_cholesky_np(x2l * x2l / nk,
                                                   max_rank=200)
    piv_m, rank_m, _ = t_pc.pivoted_cholesky_pairgram(t(u), nk, 200)
    assert rank_d == rank_m
    np.testing.assert_array_equal(piv_d[:rank_d], piv_m[:rank_d])
    # a real AO matrix (the gamma point) takes the same path
    piv_r, rank_r, _ = t_pc.pivoted_cholesky_pairgram(t(flat.real.copy()),
                                                      1, 50)
    xr = flat.real @ flat.real.T
    _, piv_rd, rank_rd, _ = t_pc.pivoted_cholesky_np(xr * xr, max_rank=50)
    assert rank_r == rank_rd
    np.testing.assert_array_equal(piv_r, piv_rd)


def test_pairgram_equals_dense_route_through_k1():
    """On a k-axis closed under conjugation (x_{-k} = conj(x_k)) the
    matrix-free factorisation of the time-reversal-halved, sqrt-weighted
    columns equals the dense route of the build-dtype selection,
    pivoted_cholesky(pair_gram_sq(x0) * nk): same pivots and residuals."""
    rng = np.random.default_rng(3)
    ng0, nao = 180, 5
    xg = rng.standard_normal((1, ng0, nao)) + 0j          # k = 0: real
    xp = (rng.standard_normal((1, ng0, nao))
          + 1j * rng.standard_normal((1, ng0, nao)))
    x0 = np.concatenate([xg, xp, xp.conj()])              # k, +k, -k
    nk = 3
    x4 = pair_gram_sq(t(x0), square=False) * nk
    _, piv_d, rank_d, hist_d = t_pc.pivoted_cholesky(x4, max_rank=60)
    half = np.concatenate([xg, xp])                       # canonical half
    wk = np.array([1.0, 2.0])
    flat = np.transpose(half, (1, 0, 2)).reshape(ng0, 2 * nao) \
        * np.repeat(np.sqrt(wk), nao)[None, :]
    piv_m, rank_m, hist_m = t_pc.pivoted_cholesky_pairgram(t(flat), nk, 60)
    assert rank_m == rank_d
    np.testing.assert_array_equal(piv_m, piv_d.numpy())
    np.testing.assert_allclose(hist_m, hist_d.numpy(), rtol=1e-9,
                               atol=1e-12 * hist_m[0])


# ------------------------------------------------------- solvers in a build
@pytest.fixture(scope="module")
def diamond_ridge():
    """Diamond gth-szv ke 50 1x1x2, c0 10: (port cell, kpts, the JAX
    package's builds (ridge and each eigh-family solver: mask and J/K on
    the density, recorded in tests/data/jax_port_refs.json
    ``jax_sides``), the density)."""
    import json
    from pathlib import Path

    kw = dict(basis="gth-szv", pseudo="gth-pade", ke_cutoff=50.0)
    cell = structure.to_cell(*structure.bulk_diamond(), **kw)
    kpts = cell.get_kpts([1, 1, 2])
    rec = json.loads((Path(__file__).parent / "data"
                      / "jax_port_refs.json").read_text())["jax_sides"][
                          "solver_builds"]
    rng = np.random.default_rng(0)
    nao = cell.nao_nr()
    dm = rng.standard_normal((2, nao, nao)) * 0.1 + np.eye(nao)[None]
    dm = (dm + dm.transpose(0, 2, 1)).astype(np.complex128)
    return cell, kpts, rec, dm


def _recorded_jk(rec):
    return tuple((np.asarray(rec[x]["re"]) + 1j * np.asarray(rec[x]["im"])
                  ).reshape(rec[x]["shape"]) for x in ("vj", "vk"))


@pytest.mark.parametrize("solver", ["lstsq", "pinv", "svd"])
def test_build_with_eigh_solvers_matches_jax(diamond_ridge, solver):
    """A build with each eigh-family solver on the JAX package's points
    serves the J/K of the JAX package's build with that solver (1e-7
    relative: a truncated eigh of normal matrices with cond ~1e10), and
    stays within the compression error (1e-3) of the ridge build."""
    import warnings

    cell, kpts, rec, dm = diamond_ridge
    mask = np.asarray(rec["ridge"]["mask"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 7), verbose=0,
                     solver=solver, device="cpu").build(mask=mask)
    np.testing.assert_array_equal(np.asarray(rec[solver]["mask"]), mask)
    vj, vk = df.get_jk(dm)
    vj_j, vk_j = _recorded_jk(rec[solver])
    assert _rel(vj.numpy(), vj_j) < 1e-7 and _rel(vk.numpy(), vk_j) < 1e-7
    vj_r, vk_r = _recorded_jk(rec["ridge"])
    assert _rel(vj.numpy(), vj_r) < 1e-3 and _rel(vk.numpy(), vk_r) < 1e-3


def test_solver_variants_agree():
    """tests/test_isdf_kpoint.py::test_solver_variants_agree on the port:
    the eigh-family solvers give the same physical output (an ERI block;
    w_q itself differs in the fit's near-null space): lstsq = pinv to
    1e-10, lstsq vs svd to 1e-6."""
    import warnings
    from fftisdf_tpu_torch.lattice.cell import Cell

    cell = Cell(a=np.diag([5.0, 5.0, 7.0]),
                atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
                basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 21]),
                unit="bohr", precision=1e-12).build()
    kpts = cell.get_kpts([1, 1, 2])
    eris = {}
    for solver in ("lstsq", "pinv", "svd"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            df = FFTISDF(cell, kpts, c0=8.0, m0=(9, 9, 13), solver=solver,
                         verbose=0, device="cpu").build()
        eris[solver] = df.get_eri((0, 1, 1, 0)).numpy()
    np.testing.assert_allclose(eris["lstsq"], eris["pinv"], atol=1e-10)
    np.testing.assert_allclose(eris["lstsq"], eris["svd"], atol=1e-6)
