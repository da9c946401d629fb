"""Analytic stress of the PyTorch port (``scf.stress``) against the JAX
package.

For each case of ``tests/torch_deriv_fixtures.py`` (but the ISDF screened
hybrid, whose strain derivative the JAX package cannot take) the port's
strain Lagrangian on the JAX package's converged density and mask
(tests/data/jax_port_refs.json, ``derivatives``) reproduces the JAX value
and stress tensor to 1e-8 relative.  The port's own ISDF stress is held to
a central difference of its own re-converged energies under isotropic
strain (the JAX stress tests' tolerances), and the strain-differentiable
Ewald and Madelung sums to the host constants.
"""
import numpy as np
import pytest
import torch

import torch_deriv_fixtures as fx
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.scf import KRHF, integrals
from fftisdf_tpu_torch.scf import stress as scf_stress
from test_torch_autodiff_forces import REFS, frozen_df, jax_scf
from torch_test_threads import two_torch_threads  # noqa: F401

STRESS_CASES = [c for c in fx.CASES if c[0] not in fx.NO_STRESS]


@pytest.fixture(scope="module")
def he2():
    cell = fx.he2_strain(Cell, Shell)
    return cell, cell.get_kpts([1, 1, 2])


@pytest.mark.parametrize("name, cls, kw, backend", STRESS_CASES,
                         ids=[c[0] for c in STRESS_CASES])
def test_stress_matches_jax(he2, name, cls, kw, backend):
    cell, kpts = he2
    rec = REFS["cases"][name]
    mf = jax_scf(cell, kpts, name, kw)
    df = frozen_df(cell, kpts) if backend == "isdf" else None
    sigma, p, val = scf_stress.kernel(mf, two_electron=backend, df=df)
    s_ref = np.asarray(rec["sigma"])
    assert abs(val - rec["stress_value"]) <= 1e-8 * abs(val)
    assert np.abs(sigma - s_ref).max() <= 1e-8 * np.abs(s_ref).max()
    assert abs(p - rec["pressure"]) <= 1e-8 * np.abs(s_ref).max()
    assert np.abs(sigma - sigma.T).max() < 1e-14


def test_isdf_stress_vs_finite_difference(he2):
    """The ISDF stress (frozen mask) of the port's own SCF against central
    differences of its re-converged ISDF energies on strained cells (same
    fractional mask, same mesh): -3 V P = dE/d(isotropic strain)."""
    cell0, kpts0 = he2
    a0 = np.asarray(cell0.a)
    kscaled = cell0.get_scaled_kpts(kpts0)

    def scf(A, mask=None):
        cell = fx.he2_strain(Cell, Shell, a_mat=A)
        kpts = kscaled @ cell.reciprocal_vectors()
        df = FFTISDF(cell, kpts, verbose=0, device="cpu",
                     **fx.ISDF_BUILD).build(mask=mask)
        mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-11, device="cpu")
        mf.kernel()
        assert mf.converged
        return mf, df

    mf, df = scf(a0)
    sigma, p, val = scf_stress.kernel(mf, two_electron="isdf", df=df)
    assert abs(val - mf.e_tot) < 1e-9
    h = 1e-4
    es = [scf(a0 * (1.0 + s), df.mask)[0].e_tot for s in (+h, -h)]
    fd = (es[0] - es[1]) / (2 * h)
    vol = float(cell0.vol)
    assert abs(-3.0 * vol * p - fd) <= 2e-5 * abs(fd) + 1e-6, (
        -3.0 * vol * p, fd)


def test_ewald_and_madelung_strain_fns(he2):
    cell, kpts = he2
    a0 = torch.as_tensor(np.asarray(cell.a), dtype=torch.float64)
    e = scf_stress.ewald_strain_fn(cell, device="cpu")(a0)
    assert abs(float(e) - integrals.ewald(cell)) < 1e-10
    mad = scf_stress.madelung_strain_fn(cell, (1, 1, 2), device="cpu")(a0)
    assert abs(float(mad) - integrals.madelung(cell, (1, 1, 2))) < 1e-10


def test_stress_guards(he2):
    cell, kpts = he2
    mf = jax_scf(cell, kpts, "pw_rhf_ewald", {"exxdiv": "ewald"})
    with pytest.raises(ValueError, match="exxdiv"):
        scf_stress.make_cell_grad_fn(cell, kpts, device="cpu")(mf)
    with pytest.raises(NotImplementedError):
        scf_stress.make_cell_energy_fn(cell, kpts, exxdiv="vcut_sph",
                                       device="cpu")
