"""PyTorch port of the SCF layer against the JAX package (CPU, f64).

- one-electron setup (overlap, kinetic, local and nonlocal GTH) and the
  Ewald energy on diamond gth-szv ke 50, to 1e-10;
- the host SCF numerics (DIIS, ADIIS, smearing) on seeded inputs;
- ISDF-KUHF on diamond (c0 10, AFM bias, smearing), e_tot to 1e-8 Ha;
- the slice as a whole on the NiO AFM example's defaults
  (examples/nio_afm_kuhf.py): e_tot to 1e-6 Ha and the Ni moments to
  1e-3.  That cell's selection meets exact symmetry ties, which the two
  packages break differently (a different but equally valid compressed
  basis, ~5e-5 Ha apart), so the port is handed the JAX package's mask
  and compared from the metric pass on.  The looser energy tolerance is
  the level at which the ADIIS/CDIIS trajectory wanders before it
  converges.

Each package gets its own cell, built by its own structure constructors from
the same arguments.
"""
import warnings

import numpy as np
import pytest
import torch

from fftisdf_tpu.isdf import FFTISDF as JaxISDF
from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.scf import KRHF as JaxKRHF, KUHF as JaxKUHF
from fftisdf_tpu.scf import core as jax_core
from fftisdf_tpu.scf import integrals as jax_int
from fftisdf_tpu.scf.analysis import atom_charges_and_moments as jax_moments
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.scf import KUHF, core, integrals
from fftisdf_tpu_torch.scf.analysis import atom_charges_and_moments
from torch_test_threads import two_torch_threads  # noqa: F401

AFM = {0: +1.0, 1: -1.0}


def _cells(maker, **kw):
    """(JAX package's cell, port's cell) from the same arguments."""
    return (jax_structure.to_cell(*getattr(jax_structure, maker)(), **kw),
            structure.to_cell(*getattr(structure, maker)(), **kw))


@pytest.fixture(scope="module")
def diamond():
    """(JAX package's cell, port's cell, kpts)."""
    cell_j, cell = _cells("bulk_diamond", basis="gth-szv", pseudo="gth-pade",
                          ke_cutoff=50.0)
    return cell_j, cell, cell.get_kpts([1, 1, 2])


def test_one_electron_setup_matches_jax(diamond):
    cell_j, cell, kpts = diamond
    mf_j = JaxKRHF(cell_j, kpts, with_df=object(), verbose=0)
    df = FFTISDF(cell, kpts, device="cpu")
    mf_t = KUHF(cell, kpts, df, verbose=0, device="cpu")
    np.testing.assert_allclose(mf_t.s1e, mf_j.s1e, atol=1e-10, rtol=0)
    np.testing.assert_allclose(mf_t.h1e, mf_j.h1e, atol=1e-10, rtol=0)
    assert abs(mf_t.e_nuc - jax_int.ewald(cell_j)) < 1e-10


def test_vloc_on_grid_matches_jax(diamond):
    cell_j, cell, _ = diamond
    ref = np.asarray(jax_int.vloc_on_grid(cell_j))
    out = integrals.vloc_on_grid(cell, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-10, rtol=0)


def test_scf_core_matches_jax():
    rng = np.random.default_rng(2)
    m, length = 5, 30
    errs = rng.standard_normal((m, length)) + 1j * rng.standard_normal(
        (m, length))
    focks = rng.standard_normal((m, length)) + 1j * rng.standard_normal(
        (m, length))
    dms = rng.standard_normal((m, length)) + 1j * rng.standard_normal(
        (m, length))
    valid = np.array([True, True, False, True, True])
    t = torch.from_numpy
    np.testing.assert_allclose(
        core.diis_extrapolate(t(errs), t(focks), t(valid)).numpy(),
        jax_core.diis_extrapolate(errs, focks, valid, np), atol=1e-12)
    np.testing.assert_allclose(
        core.adiis_coeffs(t(dms), t(focks), 4, t(valid)).numpy(),
        jax_core.adiis_coeffs(dms, focks, 4, valid, np, jax_core.fori_host),
        atol=1e-12)
    es = [np.sort(rng.standard_normal(7)), np.sort(rng.standard_normal(6))]
    for method in ("fermi", "gauss"):
        occ_t, mu_t, s_t = core.smeared_occupations(es, 3, 0.05, method)
        occ_j, mu_j, s_j = jax_core.smeared_occupations(es, 3, 0.05, method)
        for a, b in zip(occ_t, occ_j):
            np.testing.assert_allclose(a, b, atol=1e-12)
        assert abs(mu_t - mu_j) < 1e-12 and abs(s_t - s_j) < 1e-12
    e = rng.standard_normal((3, 6))
    ok = np.ones((3, 6), dtype=bool)
    ok[1, 5] = False
    np.testing.assert_array_equal(core.aufbau_occ(t(e), t(ok), 2).numpy(),
                                  jax_core.aufbau_occ(e, ok, 2, np))


def test_isdf_kuhf_diamond_matches_jax(diamond):
    cell_j, cell, kpts = diamond
    kw = dict(verbose=0, conv_tol=1e-10, max_cycle=80, init_spin=AFM,
              smearing=5e-3)
    df_j = JaxISDF(cell_j, kpts, c0=10.0, m0=(15, 15, 15), verbose=0).build()
    mf_j = JaxKUHF(cell_j, kpts, with_df=df_j, **kw)
    e_j = mf_j.kernel()
    df_t = FFTISDF(cell, kpts, c0=10.0, m0=(15, 15, 15), verbose=0,
                   device="cpu").build()
    mf_t = KUHF(cell, kpts, df_t, device="cpu", **kw)
    e_t = mf_t.kernel()
    assert mf_j.converged and mf_t.converged
    assert abs(e_t - e_j) < 1e-8, (e_t, e_j)


def test_nio_example_slice_matches_jax():
    """NiO AFM, gth-szv ke 50, 1x1x2, c0 20, m0 15^3, smearing 5e-3 — the
    defaults of examples/nio_afm_kuhf.py — through both packages."""
    cell_j, cell = _cells("nio_afm", basis="gth-szv", pseudo="gth-pade",
                          ke_cutoff=50.0, exp_to_discard=0.1)
    kpts = cell.get_kpts([1, 1, 2])
    kw = dict(verbose=0, conv_tol=1e-8, max_cycle=80, init_spin=AFM,
              smearing=5e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df_j = JaxISDF(cell_j, kpts, c0=20.0, m0=(15, 15, 15),
                       verbose=0).build()
    mf_j = JaxKUHF(cell_j, kpts, with_df=df_j, **kw)
    e_j = mf_j.kernel()
    _, mom_j = jax_moments(cell_j, mf_j.dm, mf_j.s1e)

    df_t = FFTISDF(cell, kpts, c0=20.0, m0=(15, 15, 15), verbose=0,
                   device="cpu").build(mask=np.asarray(df_j.mask))
    mf_t = KUHF(cell, kpts, df_t, device="cpu", **kw)
    e_t = mf_t.kernel()
    _, mom_t = atom_charges_and_moments(cell, mf_t.dm, mf_t.s1e)
    assert mf_j.converged and mf_t.converged
    assert abs(e_t - e_j) < 1e-6, (e_t, e_j)
    np.testing.assert_allclose(mom_t[:2], mom_j[:2], atol=1e-3)
    assert mom_t[0] > 1.0 > -1.0 > mom_t[1]
