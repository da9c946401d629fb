"""The port's FCI (``scf.fci``) and DMET (``scf.dmet``) against the JAX
package's, on the CPU.

- FCI: the port's determinant solver against the JAX package's (numpy
  only, run here) and against an independent dense Jordan-Wigner
  construction at random complex integrals: energy 1e-9, both RDMs 1e-9;
  the RDM conventions are pinned by the solver's internal E(gamma, Gamma)
  == eigenvalue assert.
- The CCSD impurity solver (``scf.cc.ccsd_solver``) on the JAX test's
  random embedding problem: = FCI for 2 electrons, and the JAX package's
  energy and RDMs (recorded) for 2 and 4 electrons, 1e-9.
- DMET on the JAX package's points and orbitals (tests/data/
  jax_port_refs.json, ``many_body`` and ``correlated``): the H2 chain at
  gamma (the full fragment: E_DMET = E_HF + E_corr(CCSD), exact for two
  electrons) and 1x1x2 (one H atom a fragment, with and without the mu
  fit, the FCI and the CCSD solvers), diamond szv 1x1x2 with the 2s AO of
  one carbon as the fragment; each energy to 1e-8 of the JAX package's,
  the bath size and the fitted mu as recorded.
"""
import json
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from fftisdf_tpu_torch.scf import cc
from fftisdf_tpu_torch.scf.dmet import build_embedding, dmet_energy
from fftisdf_tpu_torch.scf.fci import _MAX_ORB, fci_ground
from cc_oracle import _jw_annihilators
from test_torch_cc import state

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS.parent / "tools"))
import jax_port_refs as tool  # noqa: E402  (numpy only at import)

REFS = json.loads((TESTS / "data" / "jax_port_refs.json").read_text()
                  )["correlated"]


def _random_integrals(n, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = h + h.conj().T
    a = rng.standard_normal((n,) * 4) + 1j * rng.standard_normal((n,) * 4)
    a = a + a.transpose(2, 3, 0, 1)
    return h, a + a.transpose(1, 0, 3, 2).conj()


def _dense_jw(h, eri, na, nb):
    """Ground energy of the (na, nb) sector from dense Jordan-Wigner
    matrices (tests/test_dmet.py's independent construction)."""
    n = h.shape[0]
    nm = 2 * n
    c = _jw_annihilators(nm)
    cd = [m.T for m in c]
    H = np.zeros((2 ** nm,) * 2, dtype=complex)
    for p in range(n):
        for q in range(n):
            H += h[p, q] * (cd[p] @ c[q] + cd[n + p] @ c[n + q])
            for r in range(n):
                for s in range(n):
                    for s1 in (0, n):
                        for s2 in (0, n):
                            H += 0.5 * eri[p, q, r, s] * (
                                cd[p + s1] @ cd[r + s2]
                                @ c[s + s2] @ c[q + s1])
    occ = np.array([[(st >> (nm - 1 - b)) & 1 for b in range(nm)]
                    for st in range(2 ** nm)])
    sec = np.where((occ[:, :n].sum(1) == na) & (occ[:, n:].sum(1) == nb))[0]
    return np.linalg.eigvalsh(H[np.ix_(sec, sec)])[0]


@pytest.mark.parametrize("n,nelec", [(3, (2, 1)), (4, 4), (4, (3, 1))])
def test_fci_matches_jax_and_dense_jw(n, nelec):
    from fftisdf_tpu.scf.fci import fci_ground as jax_fci

    h, eri = _random_integrals(n, 3 + n)
    e, g, gam2 = fci_ground(h, eri, nelec, device="cpu")
    e_j, g_j, gam2_j = jax_fci(h, eri, nelec)
    assert abs(e - e_j) < 1e-9
    assert np.abs(g - g_j).max() < 1e-9 and np.abs(gam2 - gam2_j).max() < 1e-9
    assert abs(np.trace(g) - sum(np.atleast_1d(nelec))) < 1e-10
    assert np.abs(g - g.conj().T).max() < 1e-10
    if n == 3:
        assert abs(e - _dense_jw(h, eri, *nelec)) < 1e-9
    with pytest.raises(NotImplementedError):
        fci_ground(np.eye(_MAX_ORB + 1), np.zeros((_MAX_ORB + 1,) * 4), 2,
                   device="cpu")


@pytest.mark.parametrize("nelec", [2, 4])
def test_ccsd_solver_matches_jax_and_fci(nelec):
    """2 electrons: CCSD is exact, energy AND both RDMs = FCI's (the JAX
    test's 1e-8 / 1e-6); both electron counts: the JAX package's energy
    and RDMs (1e-9)."""
    from test_torch_mp2_rpa import unpack

    h, eri = tool.solver_integrals()
    e, g, gam2 = cc.ccsd_solver(h, eri, nelec, device="cpu")
    rec = REFS["ccsd_solver"][str(nelec)]
    assert abs(e - rec["e"]) < 1e-9
    assert np.abs(g - unpack(rec["gamma"])).max() < 1e-9
    assert np.abs(gam2 - unpack(rec["Gamma"])).max() < 1e-9
    ef, gf, gam2f = fci_ground(h, eri, nelec, device="cpu")
    if nelec == 2:
        assert abs(e - ef) < 1e-8
        assert np.abs(g - gf).max() < 1e-6 and np.abs(gam2 - gam2f).max() < 1e-6
    else:
        assert e > ef and abs(e - ef) < 1e-2


@lru_cache(maxsize=None)
def _dmet(key, frag, kind):
    df, mf = state(key)
    solver = cc.ccsd_solver if kind.startswith("ccsd") else None
    return dmet_energy(mf, df, frag_ao=list(frag), solver=solver,
                       fit_mu=kind.endswith("_mu"))


CASES = [(key, frag, kind) for key, frag, kinds in tool.DMET_CASES
         for kind in kinds if (key, frag) != ("diamond", (0, 1, 2, 3))]


@pytest.mark.parametrize("key,frag,kind", CASES)
def test_dmet_matches_jax(key, frag, kind):
    rec = REFS["dmet"][f"{key} {list(frag)} {kind}"]
    e, info = _dmet(key, frag, kind)
    assert abs(e - rec["e"]) < 1e-8 * abs(rec["e"]), (e, rec["e"])
    assert abs(info["de_corr"] - rec["de_corr"]) < 1e-8
    assert info["nbath"] == rec["nbath"] and info["nemb"] == rec["nemb"]
    assert abs(info.get("mu", 0.0) - rec["mu"]) < 1e-6
    assert info["de_corr"] < 0 and abs(info["de_imag"]) < 1e-8
    if kind.endswith("_mu"):
        assert info.get("nfrag_err", 0.0) < 1e-6


def test_dmet_identities():
    """Gamma, fragment = every AO: the embedding IS the molecule, no bath,
    and E_DMET = E_HF + E_corr(CCSD) (exact for 2 electrons, a disjoint
    code path); the embedding's invariants on the 1x1x2 chain."""
    df, mf = state("h2_gamma")
    e_dmet, info = _dmet("h2_gamma", (0, 1, 2, 3), "fci")
    assert info["nbath"] == 0
    e_cc, cinfo = cc.kccsd(df, mf, conv_tol=1e-10, max_cycle=80)
    assert cinfo["converged"] and abs(e_dmet - (mf.e_tot + e_cc)) < 1e-7
    df, mf = state("h2_k2")
    c_ao_lo, gamma_mf, nfrag, info = build_embedding(mf, [0, 1])
    assert c_ao_lo.shape == (2, 4, 2 + info["nbath"]) and nfrag == 2
    ne = float(np.trace(gamma_mf).real)
    assert abs(ne - round(ne)) < 1e-6
    # the two fragments' corrections sum to the lattice's correlation
    # within the embedding approximation (tests/test_dmet.py's bound)
    total = (_dmet("h2_k2", (0, 1), "fci")[1]["de_corr"]
             + _dmet("h2_k2", (2, 3), "fci")[1]["de_corr"])
    e_cc, _ = cc.kccsd(df, mf, conv_tol=1e-9, max_cycle=80)
    assert 0.5 * abs(e_cc) < abs(total) < 1.5 * abs(e_cc)
