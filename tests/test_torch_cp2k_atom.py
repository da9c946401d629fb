"""The port's CP2K data ingest (``basis.data``), radial pseudo-atom
(``basis.atom``) and GTH fit (``basis.fit``) against the JAX package's.

The CP2K cases are tests/test_cp2k_ingest.py's, on the port's registry,
with each parse of the port equal to the JAX package's parse of the same
text; the override's SCFs are the port's.  The atom and fit modules are
numpy/scipy copies, so on the cheap cases of tests/test_atom.py (the
Teter-Pade anchor, the hydrogenic atom, the occupations, one small-grid
LDA atom, the radial Gaussian fit) their results are equal to the JAX
package's to the bit, beside test_atom.py's own gates.  The GTH refit and
the Ni / C provenance cases cost minutes on the host, which
tests/test_atom.py already spends: they are marked slow here.
"""
import warnings

import numpy as np
import pytest

from fftisdf_tpu.basis import atom as jax_atom
from fftisdf_tpu.basis import data as jax_data
from fftisdf_tpu_torch.basis import atom, data
from fftisdf_tpu_torch.basis.atom import (RadialGrid, ae_occupations,
                                          compare_pseudo,
                                          fit_radial_gaussians,
                                          pseudo_occupations, solve_atom,
                                          teter_pade_exc)
from fftisdf_tpu_torch.basis.data import (GTHPseudo, _PSEUDO_PADE, _h,
                                          hgh_offdiag_deviation,
                                          load_pseudo)

GRID = RadialGrid(rmax=30.0, n=700)


# ------------------------------------------------ tests/test_cp2k_ingest.py
def _format_cp2k_basis(elem, shells, name="TEST-BASIS"):
    """Format registry-style shells [(l, rows)] as a CP2K BASIS entry
    (each (l, rows) pair its own set)."""
    lines = [f"{elem}  {name}", f" {len(shells)}"]
    for l, rows in shells:
        rows = np.asarray(rows, dtype=np.float64)
        nexp, ncol = rows.shape
        lines.append(f" 1 {l} {l} {nexp} {ncol - 1}")
        for r in rows:
            lines.append("  " + "  ".join(f"{v:.10f}" for v in r))
    return "\n".join(lines) + "\n"


def _format_cp2k_pseudo(elem, ps, zshell, name="GTH-TEST"):
    """Format a GTHPseudo as a CP2K GTH_POTENTIALS entry (upper-triangle
    h rows, the CP2K convention the parser must invert)."""
    lines = [f"{elem}  {name}",
             " " + " ".join(str(int(z)) for z in zshell)]
    loc = [f"{ps.rloc:.8f}", str(len(ps.cloc))]
    loc += [f"{c:.8f}" for c in ps.cloc]
    lines.append("  " + "  ".join(loc))
    lines.append(f"  {len(ps.projectors)}")
    for l, rl, h in ps.projectors:
        n = h.shape[0]
        row0 = [f"{rl:.8f}", str(n)] + [f"{h[0, j]:.8f}" for j in range(n)]
        lines.append("  " + "  ".join(row0))
        for i in range(1, n):
            lines.append("    " + "  ".join(f"{h[i, j]:.8f}"
                                            for j in range(i, n)))
    return "\n".join(lines) + "\n"


def _same_basis(a, b):
    assert list(a) == list(b)
    for elem in a:
        assert [l for l, _ in a[elem]] == [l for l, _ in b[elem]]
        for (_, r1), (_, r2) in zip(a[elem], b[elem]):
            assert np.array_equal(np.asarray(r1), np.asarray(r2))


def _same_pseudo(p, q):
    assert (p.zion, p.rloc) == (q.zion, q.rloc)
    assert np.array_equal(p.cloc, q.cloc)
    assert len(p.projectors) == len(q.projectors)
    for (l0, r0, h0), (l1, r1, h1) in zip(p.projectors, q.projectors):
        assert l0 == l1 and r0 == r1 and np.array_equal(h0, h1)


def test_cp2k_basis_roundtrip():
    """Embedded H gth-szv -> CP2K text -> parse == registry entry."""
    shells = data._BASIS["gth-szv"]["H"]
    text = "# synthetic BASIS file\n" + _format_cp2k_basis("H", shells)
    parsed = data.parse_cp2k_basis(text)
    _same_basis(parsed, jax_data.parse_cp2k_basis(text))
    assert list(parsed) == ["H"]
    assert len(parsed["H"]) == len(shells)
    for (l_ref, rows_ref), (l_new, rows_new) in zip(shells, parsed["H"]):
        assert l_ref == l_new
        np.testing.assert_allclose(rows_new, np.asarray(rows_ref),
                                   rtol=0, atol=1e-9)


def test_cp2k_basis_multiset_shared_exponents():
    """A CP2K set with lmin < lmax shares one exponent block across l
    channels (the BASIS_MOLOPT layout): the parser splits the columns."""
    text = """
H TESTSET
 1
 1 0 1 3 2 1
   10.0   0.1  0.0   0.5
    1.0   0.9  0.2   0.4
    0.1   0.0  1.0   0.3
"""
    parsed = data.parse_cp2k_basis(text)
    _same_basis(parsed, jax_data.parse_cp2k_basis(text))
    shells = parsed["H"]
    assert [l for l, _ in shells] == [0, 1]
    s_rows = np.asarray(shells[0][1])
    p_rows = np.asarray(shells[1][1])
    assert s_rows.shape == (3, 3) and p_rows.shape == (3, 2)
    np.testing.assert_allclose(s_rows[:, 0], [10.0, 1.0, 0.1])
    np.testing.assert_allclose(s_rows[:, 2], [0.0, 0.2, 1.0])
    np.testing.assert_allclose(p_rows[:, 1], [0.5, 0.4, 0.3])


def test_cp2k_pseudo_roundtrip_ni_q18():
    """Embedded Ni q18 (multi-l, 2x2 blocks with off-diagonal h) -> CP2K
    text -> parse reproduces zion/rloc/cloc/projectors."""
    ps = data.load_pseudo("gth-pade", "Ni")
    text = ("# synthetic GTH_POTENTIALS\n"
            + _format_cp2k_pseudo("Ni", ps, zshell=(10, 8),
                                  name="GTH-PADE-q18"))
    parsed = data.parse_cp2k_pseudo(text)
    _same_pseudo(parsed["Ni"], jax_data.parse_cp2k_pseudo(text)["Ni"])
    new = parsed["Ni"]
    assert new.zion == ps.zion
    assert abs(new.rloc - ps.rloc) < 1e-12
    np.testing.assert_allclose(new.cloc, ps.cloc, atol=1e-8)
    assert len(new.projectors) == len(ps.projectors)
    for (l0, r0, h0), (l1, r1, h1) in zip(ps.projectors, new.projectors):
        assert l0 == l1
        assert abs(r0 - r1) < 1e-12
        np.testing.assert_allclose(h1, h0, atol=1e-8)
        np.testing.assert_allclose(h1, h1.T, atol=0)  # symmetrized


def test_load_cp2k_data_files_override(tmp_path):
    """File-registered tables override the embedded ones: loaded through
    the file plumbing, resolved with no fallback, nao changed and the
    port's SCF energy lowered variationally."""
    from fftisdf_tpu_torch.lattice import structure
    from fftisdf_tpu_torch.scf import KRHF

    szv_rows = np.asarray(data._BASIS["gth-szv"]["H"][0][1])
    shells = [(0, szv_rows.tolist()), (0, [(0.08, 1.0)])]
    bpath = tmp_path / "BASIS_TEST"
    bpath.write_text(_format_cp2k_basis("H", shells, name="TEST-DZ"))
    ppath = tmp_path / "GTH_POTENTIALS_TEST"
    ps_h = data.load_pseudo("gth-pade", "H")
    ppath.write_text(_format_cp2k_pseudo("H", ps_h, zshell=(1,),
                                         name="GTH-TEST-q1"))
    saved = data._BASIS.get("test-cp2k-dz")
    try:
        data.load_cp2k_data_files(basis_path=str(bpath),
                                  potentials_path=str(ppath),
                                  basis_name="test-cp2k-dz",
                                  pseudo_name="test-cp2k-pade")
        assert "test-cp2k-dz" not in jax_data._BASIS
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            loaded = data.load_basis("test-cp2k-dz", "H")
        assert len(loaded) == 2
        ps_loaded = data.load_pseudo("test-cp2k-pade", "H")
        np.testing.assert_allclose(ps_loaded.cloc, ps_h.cloc, atol=1e-8)

        lat = np.eye(3) * 6.0
        atoms = [("H", np.array([2.6, 3.0, 3.0])),
                 ("H", np.array([3.4, 3.0, 3.0]))]
        cell_s = structure.to_cell(lat, atoms, basis="gth-szv",
                                   pseudo="gth-pade", ke_cutoff=20.0)
        cell_c = structure.to_cell(lat, atoms, basis="test-cp2k-dz",
                                   pseudo="test-cp2k-pade", ke_cutoff=20.0)
        assert cell_s.nao_nr() == 2 and cell_c.nao_nr() == 4
        kpts = cell_s.get_kpts([1, 1, 1])
        e_s = KRHF(cell_s, kpts, verbose=0, conv_tol=1e-9,
                   device="cpu").kernel()
        e_c = KRHF(cell_c, kpts, verbose=0, conv_tol=1e-9,
                   device="cpu").kernel()
        # bigger basis is variational: strictly lower, same physics scale
        assert e_c < e_s
        assert e_s - e_c < 0.05
    finally:
        if saved is None:
            data._BASIS.pop("test-cp2k-dz", None)
        else:
            data._BASIS["test-cp2k-dz"] = saved
        data._PSEUDO_LIBRARY.pop("test-cp2k-pade", None)


def test_cp2k_env_var_plumbing(tmp_path, monkeypatch):
    """The environment-variable default of load_cp2k_data_files (the JAX
    package's names) registers under the production names."""
    shells = [(0, [(1.0, 1.0)])]
    bpath = tmp_path / "BASIS_MOLOPT"
    bpath.write_text(_format_cp2k_basis("He", shells, name="TEST"))
    monkeypatch.setenv("FFTISDF_TPU_CP2K_BASIS", str(bpath))
    monkeypatch.delenv("FFTISDF_TPU_CP2K_POTENTIALS", raising=False)
    saved = dict(data._BASIS.get("gth-dzvp-molopt-sr", {}))
    try:
        data.load_cp2k_data_files()
        assert "He" in data._BASIS["gth-dzvp-molopt-sr"]
        assert "He" not in jax_data._BASIS.get("gth-dzvp-molopt-sr", {})
    finally:
        data._BASIS["gth-dzvp-molopt-sr"] = saved


# -------------------------------------------------- tests/test_atom.py
def _equal_results(r, r_j):
    """Two AtomResults equal to the bit."""
    assert r.converged == r_j.converged and r.e_tot == r_j.e_tot
    assert sorted(r.eps) == sorted(r_j.eps)
    for l in r.eps:
        assert np.array_equal(r.eps[l], r_j.eps[l])
        assert np.array_equal(np.asarray(r.u[l]), np.asarray(r_j.u[l]))


def test_teter_pade_exchange_anchor():
    """rs -> 0 is pure exchange: a0 = (3/4)(3/2pi)^(2/3); exc and vxc
    equal the JAX package's on a density ladder."""
    a0_exact = 0.75 * (1.5 / np.pi) ** (2.0 / 3.0)
    assert abs(atom._TP_A[0] - a0_exact) < 1e-12
    n = 1e6
    rs = (3.0 / (4.0 * np.pi * n)) ** (1.0 / 3.0)
    exc, vxc = teter_pade_exc(np.array([n]))
    assert abs(exc[0] * rs / a0_exact + 1.0) < 0.05
    h = n * 1e-5
    ep, _ = teter_pade_exc(np.array([n + h]))
    em, _ = teter_pade_exc(np.array([n - h]))
    d_nexc = ((n + h) * ep[0] - (n - h) * em[0]) / (2 * h)
    assert abs(vxc[0] - d_nexc) < 1e-6 * abs(vxc[0])
    ladder = np.geomspace(1e-8, 1e6, 57)
    for a, b in zip(teter_pade_exc(ladder), jax_atom.teter_pade_exc(ladder)):
        assert np.array_equal(a, b)


def test_hydrogenic_exact():
    """Bare -Z/r, no Hartree, no xc: eps_nl = -Z^2/(2 n^2), equal to the
    JAX package's solve."""
    kw = dict(xc=None, coulomb=False, occ={0: [1.0, 1.0], 1: [1.0]})
    r = solve_atom("H", grid=GRID, **kw)
    assert abs(r.eps[0][0] + 0.5) < 2e-5
    assert abs(r.eps[0][1] + 0.125) < 2e-5
    assert abs(r.eps[1][0] + 0.125) < 2e-5
    u = r.u[0][0]
    assert abs(r.grid.integrate(u * u) - 1.0) < 1e-10
    _equal_results(r, jax_atom.solve_atom(
        "H", grid=jax_atom.RadialGrid(rmax=30.0, n=700), **kw))


def test_occupation_logic():
    assert ae_occupations("Ni") == {0: [2.0, 2.0, 2.0, 2.0],
                                    1: [6.0, 6.0], 2: [8.0]}
    ni = load_pseudo("gth-pade", "Ni")       # q18: strip 1s 2s 2p
    assert pseudo_occupations("Ni", ni) == {0: [2.0, 2.0],
                                            1: [6.0], 2: [8.0]}
    c = load_pseudo("gth-pade", "C")         # q4: strip 1s
    assert pseudo_occupations("C", c) == {0: [2.0], 1: [2.0]}
    for sym in ("H", "C", "O", "Si", "Ni"):
        assert ae_occupations(sym) == jax_atom.ae_occupations(sym)
        assert pseudo_occupations(sym, load_pseudo("gth-pade", sym)) == \
            jax_atom.pseudo_occupations(sym,
                                        jax_data.load_pseudo("gth-pade", sym))
    fake = GTHPseudo(3, 0.3, np.array([-4.0]))   # C with zion=3
    with pytest.raises(ValueError):
        pseudo_occupations("C", fake)


def test_small_grid_lda_pseudo_atom_matches_jax():
    """One self-consistent LDA solve on a small grid: the H gth-pade
    pseudo-atom, equal to the JAX package's to the bit, with the
    provenance discriminator's valence eigenvalue (tests/test_atom.py's
    5e-4 band)."""
    g = RadialGrid(rmax=20.0, n=300)
    r = solve_atom("H", pseudo="gth-pade", grid=g)
    r_j = jax_atom.solve_atom("H", pseudo="gth-pade",
                              grid=jax_atom.RadialGrid(rmax=20.0, n=300))
    assert r.converged
    _equal_results(r, r_j)
    assert hgh_offdiag_deviation(load_pseudo("gth-pade", "H")) == 0.0


def test_hgh_offdiag_relations():
    """Every embedded GTH-PADE entry satisfies the HGH-1998 h12/h22
    relation (the JAX package's values); the old Si h22 fails it."""
    for sym, ps in _PSEUDO_PADE.items():
        dev = hgh_offdiag_deviation(ps)
        assert dev < 1e-3, sym
        assert dev == jax_data.hgh_offdiag_deviation(
            jax_data.load_pseudo("gth-pade", sym))
    bad = GTHPseudo(4, 0.44, np.array([-7.33610297]),
                    [(0, 0.42273813, _h([5.90692831, -1.26189397],
                                        [2.93454196]))])  # the old Si h22
    assert hgh_offdiag_deviation(bad) > 1e-2


def test_fit_radial_gaussians_roundtrip():
    """A normalized primitive comes back exactly; hydrogen 1s in a
    3-Gaussian set at a few percent; both equal to the JAX package's."""
    from fftisdf_tpu_torch.basis.gto import gto_norm

    g = RadialGrid(rmax=30.0, n=900)
    g_j = jax_atom.RadialGrid(rmax=30.0, n=900)
    exps = np.array([2.5, 0.8, 0.2])
    target = 1
    u = gto_norm(1, exps[target]) * g.r ** 2 * np.exp(-exps[target] * g.r ** 2)
    c, resid = fit_radial_gaussians(u, 1, exps, g)
    c_j, resid_j = jax_atom.fit_radial_gaussians(u, 1, exps, g_j)
    assert np.array_equal(c, c_j) and resid == resid_j
    want = np.zeros(3)
    want[target] = 1.0
    assert np.allclose(c, want, atol=1e-8)
    assert resid < 1e-7
    r = solve_atom("H", xc=None, coulomb=False, grid=g)
    sto = np.array([3.42525091, 0.62391373, 0.16885540])
    c, resid = fit_radial_gaussians(r.u[0][0], 0, sto, g)
    c_j, resid_j = jax_atom.fit_radial_gaussians(r.u[0][0], 0, sto, g_j)
    assert np.array_equal(c, c_j) and resid == resid_j
    assert (c > 0).all() and resid < 0.06


# ---------------------------- the host-expensive cases of test_atom.py
@pytest.mark.slow
def test_fit_gth_recovers_genuine_carbon():
    """tests/test_atom.py's GTH-96 refit from a corrupted C table, through
    the port's fit_gth, equal to the JAX package's fit."""
    from fftisdf_tpu.basis.fit import fit_gth as jax_fit_gth
    from fftisdf_tpu_torch.basis.fit import fit_gth

    good = load_pseudo("gth-pade", "C")
    bad = GTHPseudo(good.zion, good.rloc, good.cloc + np.array([0.8, -0.3]),
                    [(0, good.projectors[0][1], _h([9.52284179 + 1.5]))])
    fitted, info = fit_gth("C", bad, grid=GRID)
    assert info["converged"]
    assert info["maxerr"] < 5e-4
    assert info["max_qerr"] < 1e-4
    assert np.allclose(fitted.cloc, good.cloc, atol=5e-2)
    bad_j = jax_data.GTHPseudo(bad.zion, bad.rloc, bad.cloc, bad.projectors)
    fitted_j, info_j = jax_fit_gth(
        "C", bad_j, grid=jax_atom.RadialGrid(rmax=30.0, n=700))
    assert np.array_equal(fitted.cloc, fitted_j.cloc)
    assert info["maxerr"] == info_j["maxerr"]


@pytest.mark.slow
@pytest.mark.parametrize("sym,pp", [("Ni", {(0, 0), (1, 0), (0, 1),
                                            (0, 2)}),
                                    ("C", {(0, 0), (0, 1)})])
def test_compare_pseudo_matches_jax(sym, pp):
    """tests/test_atom.py's Ni and C provenance gates, equal to the JAX
    package's discriminator."""
    out = compare_pseudo(sym, grid=GRID)
    out_j = jax_atom.compare_pseudo(
        sym, grid=jax_atom.RadialGrid(rmax=30.0, n=700))
    assert out["converged"] and out["maxerr"] < 1e-3
    assert set(out["pp"]) == pp
    assert out["maxerr"] == out_j["maxerr"]
