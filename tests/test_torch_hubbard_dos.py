"""The port's DFT+U (``scf.hubbard``), densities of states (``scf.dos``)
and Loewdin populations (``scf.analysis``) against the JAX package's, on
seeded inputs (CPU, float64, 1e-12).

+U: the occupation matrices, E_U, V_U and the Loewdin-frame potential of
the host functions, the torch version the device-resident loop runs,
S^1/2 by eigh and by the Denman-Beavers iteration, and the projector
indices of diamond and NiO.  DOS: a restricted and an unrestricted driver stand-in (band
energies, orbitals normalised in the metric of a seeded overlap,
occupations) through every public function of ``scf.dos``, with and
without a smeared chemical potential, Gaussian and Lorentzian.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.scf import analysis as jax_analysis
from fftisdf_tpu.scf import dos as jax_dos
from fftisdf_tpu.scf import hubbard as jax_hub
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.scf import analysis, dos, hubbard as hub

SITES = [(np.asarray([1, 2, 4]), 0.3), (np.asarray([0, 5]), 0.15)]


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max(initial=0.0) <= tol * max(np.abs(b).max(), 1.0)


def _rand_system(nk=2, nao=6, nspin=2, seed=0):
    """Seeded overlap (nk, nao, nao) and hermitian density matrices
    (tests/test_hubbard.py::_rand_system)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nk, nao, nao)) \
        + 1j * rng.standard_normal((nk, nao, nao))
    s1e = np.einsum("kmp,knp->kmn", a, a.conj()) / nao \
        + 2.0 * np.eye(nao)[None]
    d = rng.standard_normal((nspin, nk, nao, nao)) \
        + 1j * rng.standard_normal((nspin, nk, nao, nao))
    return s1e, d + np.conj(np.swapaxes(d, -1, -2))


def test_eu_and_vu_match_jax():
    s1e, dm = _rand_system()
    shalf = hub.shalf_kpts(s1e)
    _close(shalf, jax_hub.shalf_kpts(s1e))
    for n, n_j in zip(hub.occupation_matrices(dm, shalf, SITES),
                      jax_hub.occupation_matrices(dm, shalf, SITES)):
        _close(n, n_j)
    e, vu, g = hub.eu_and_vu(dm, shalf, SITES)
    e_j, vu_j, g_j = jax_hub.eu_and_vu(dm, shalf, SITES)
    assert abs(e - e_j) <= 1e-12 * max(abs(e_j), 1.0)
    _close(vu, vu_j)
    _close(g, g_j)
    _close(hub.vu_from_g(shalf, g), jax_hub.vu_from_g(shalf, g))


def test_traced_eu_vu_matches_jax():
    """The torch version against the JAX package's host one (which its
    own tests hold to its traced one bit for bit)."""
    s1e, dm = _rand_system()
    shalf = hub.shalf_kpts(s1e)
    e0, vu0, _ = jax_hub.eu_and_vu(dm, shalf, SITES)
    e1, vu1 = hub.eu_and_vu_traced(torch.from_numpy(dm),
                                   torch.from_numpy(shalf), SITES)
    assert abs(float(e1) - e0) <= 1e-12 * max(abs(e0), 1.0)
    _close(vu1.numpy(), vu0)


def test_sqrtm_traced_matches_eigh():
    """The Denman-Beavers S^1/2 against the JAX package's eigh-based one."""
    s1e, _ = _rand_system(nk=3, nao=5, seed=4)
    y = hub.sqrtm_traced(torch.from_numpy(s1e)).numpy()
    _close(y, jax_hub.shalf_kpts(s1e), tol=1e-10)


def test_projector_indices_and_sites_match_jax():
    for make, kw in ((structure.bulk_diamond, {}),
                     (structure.nio_afm, {"exp_to_discard": 0.1})):
        cell = structure.to_cell(*make(), basis="gth-szv",
                                 pseudo="gth-pade", ke_cutoff=50.0, **kw)
        jcell = jax_structure.to_cell(*getattr(jax_structure,
                                               make.__name__)(),
                                      basis="gth-szv", pseudo="gth-pade",
                                      ke_cutoff=50.0, **kw)
        spec = {ia: (l, 0.2) for ia in range(cell.natm) for l in (0, 1)}
        if make is structure.nio_afm:
            spec.update({0: (2, 0.22784), 1: (2, 0.22784)})
        for (idx, u), (idx_j, u_j) in zip(hub.build_sites(cell, spec),
                                          jax_hub.build_sites(jcell, spec)):
            np.testing.assert_array_equal(idx, idx_j)
            assert u == u_j
        with pytest.raises(ValueError):
            hub.projector_indices(cell, 0, 3)
    assert list(hub.build_sites(cell, {1: ([3, 7], 0.1)})[0][0]) == [3, 7]


def _driver(cell, restricted, seed, mu=None):
    """A converged driver's attributes on seeded data: per-k orbitals C
    with C^H S C = 1, their energies and aufbau occupations."""
    rng = np.random.default_rng(seed)
    nao = cell.nao_nr()
    nk = 3
    s1e, _ = _rand_system(nk=nk, nao=nao, nspin=1, seed=seed)
    nspin = 1 if restricted else 2
    es, cs, occs = [], [], []
    for _ in range(nspin):
        e_s, c_s, o_s = [], [], []
        for k in range(nk):
            h = rng.standard_normal((nao, nao))
            e, c = np.linalg.eigh(h + h.T)
            se, sv = np.linalg.eigh(s1e[k])
            x = sv / np.sqrt(se)[None, :]
            e_s.append(e)
            c_s.append(x @ c)
            o_s.append((np.arange(nao) < nao // 2) * (2.0 if restricted
                                                      else 1.0))
        es.append(e_s)
        cs.append(c_s)
        occs.append(o_s)
    if restricted:
        es, cs, occs = es[0], cs[0], occs[0]
    return SimpleNamespace(cell=cell, s1e=s1e, mo_energy=np.asarray(es),
                           mo_coeff=np.asarray(cs), mo_occ=np.asarray(occs),
                           mu=mu)


@pytest.mark.parametrize("restricted", [True, False])
def test_dos_matches_jax(restricted):
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    jcell = jax_structure.to_cell(*jax_structure.bulk_diamond(),
                                  basis="gth-szv", pseudo="gth-pade",
                                  ke_cutoff=50.0)
    for mu in (None, 0.05):
        mf = _driver(cell, restricted, seed=7, mu=mu)
        mf_j = SimpleNamespace(**dict(vars(mf), cell=jcell))
        assert dos.fermi_level(mf) == jax_dos.fermi_level(mf_j)
    for kind, sigma in (("gaussian", 0.02), ("lorentzian", 0.05)):
        e, d = dos.density_of_states(mf, sigma=sigma, kind=kind, npts=200)
        e_j, d_j = jax_dos.density_of_states(mf_j, sigma=sigma, kind=kind,
                                             npts=200)
        _close(e, e_j)
        _close(d, d_j)
        for groupby in ("atom", "ao"):
            _, p = dos.projected_dos(mf, energies=e, sigma=sigma, kind=kind,
                                     groupby=groupby)
            _, p_j = jax_dos.projected_dos(mf_j, energies=e, sigma=sigma,
                                           kind=kind, groupby=groupby)
            _close(p, p_j)
            # Loewdin weights resolve the identity band by band
            _close(p.sum(axis=-2), d, tol=1e-10)
        _close(dos.integrated_dos(e, d, 0.1),
               jax_dos.integrated_dos(e, d, 0.1))
    w = [np.random.default_rng(1).random((2, 8)) for _ in range(3)]
    _close(dos.dos_from_bands(mf.mo_energy.reshape(-1, 3, 8)[0], e,
                              weights=w, degeneracy=2.0),
           jax_dos.dos_from_bands(mf.mo_energy.reshape(-1, 3, 8)[0], e,
                                  weights=w, degeneracy=2.0))
    with pytest.raises(ValueError):
        dos.projected_dos(mf, groupby="shell")


@pytest.mark.parametrize("restricted", [True, False])
def test_loewdin_populations_match_jax(restricted):
    cell = structure.to_cell(*structure.nio_afm(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0,
                             exp_to_discard=0.1)
    jcell = jax_structure.to_cell(*jax_structure.nio_afm(), basis="gth-szv",
                                  pseudo="gth-pade", ke_cutoff=50.0,
                                  exp_to_discard=0.1)
    s1e, dm = _rand_system(nk=2, nao=cell.nao_nr(), seed=9)
    dm = dm[0] if restricted else dm
    for scheme in ("loewdin", "mulliken"):
        _close(analysis.ao_populations(cell, dm, s1e, scheme=scheme),
               jax_analysis.ao_populations(jcell, dm, s1e, scheme=scheme))
        for a, b in zip(
                analysis.atom_charges_and_moments(cell, dm, s1e,
                                                  scheme=scheme),
                jax_analysis.atom_charges_and_moments(jcell, dm, s1e,
                                                      scheme=scheme)):
            _close(a, b)
