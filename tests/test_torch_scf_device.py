"""The port's device-resident SCF loop (``scf.device``) and its tensor SCF
numerics (``scf.core``) against the port's host loops and the JAX package,
on the fixtures of tests/test_scf_device.py (CPU, f64).

The device loop runs here on CPU tensors; the tolerances are
tests/test_scf_device.py's.  The port is given the JAX package's
interpolation points (``build(mask=...)``), so that its energies can be
held against the JAX package's host energies too.  Those masks and energies
are the JAX package's record, tests/data/jax_port_refs.json
(tools/jax_port_refs.py, the same cells and settings).
"""
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.scf import core as jax_core
from jax_records import recorded
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.scf import KRHF, KUHF, DeviceKRHF, DeviceKUHF
from fftisdf_tpu_torch.scf import core
from fftisdf_tpu_torch.scf.device import orth_and_penalty


REFS = json.loads((Path(__file__).resolve().parent / "data"
                   / "jax_port_refs.json").read_text())


def _port_df(cell, kpts, m0, ref):
    """The port's df (c0 40) on the JAX package's recorded mask."""
    return FFTISDF(cell, kpts, c0=40.0, m0=m0, verbose=0,
                   device="cpu").build(mask=np.asarray(ref["mask"]))


@pytest.fixture(scope="module")
def diamond():
    """(JAX package's record, port's cell, kpts, port's df)."""
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    ref = REFS["scf_device_diamond"]
    return ref, cell, kpts, _port_df(cell, kpts, (9, 9, 9), ref)


def test_device_krhf_matches_host(diamond):
    ref, cell, kpts, df = diamond
    e_jax = ref["e_krhf"]
    e0 = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10,
              device="cpu").kernel()
    mf = DeviceKRHF(cell, kpts, df, verbose=0, conv_tol=1e-10, max_cycle=60,
                    device="cpu")
    e1 = mf.kernel()
    assert mf.converged
    np.testing.assert_allclose(e1, e0, atol=3e-8)
    np.testing.assert_allclose(e1, e_jax, atol=3e-8)
    assert mf.dm.shape == (len(kpts), cell.nao_nr(), cell.nao_nr())
    assert len(mf.cycle_times) == mf.cycles


def test_device_kuhf_smeared_matches_host(diamond):
    ref, cell, kpts, df = diamond
    mf0 = KUHF(cell, kpts, df, verbose=0, conv_tol=1e-10, smearing=5e-3,
               device="cpu")
    e0 = mf0.kernel()
    mf1 = DeviceKUHF(cell, kpts, df, verbose=0, conv_tol=1e-10,
                     smearing=5e-3, max_cycle=60, device="cpu")
    e1 = mf1.kernel()
    assert mf0.converged and mf1.converged
    np.testing.assert_allclose(e1, e0, atol=3e-8)
    np.testing.assert_allclose(mf1.e_free, mf0.e_free, atol=3e-8)
    np.testing.assert_allclose(e1, ref["e_kuhf_smeared"], atol=3e-8)
    np.testing.assert_allclose(mf1.e_free, ref["e_free_kuhf_smeared"],
                               atol=3e-8)
    with pytest.raises(NotImplementedError):
        DeviceKUHF(cell, kpts, df, verbose=0, level_shift=0.1,
                   device="cpu").kernel()
    with pytest.raises(NotImplementedError):
        DeviceKUHF(cell, kpts, df, verbose=0, exxdiv="ewald",
                   device="cpu").kernel()


@pytest.fixture(scope="module")
def near_dependent():
    """He2 with two nearly identical s shells per atom (near-singular
    overlap): (JAX package's record, port's cell, kpts, port's df)."""
    shells = [Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4], [0.7]])),
              Shell(l=0, exps=np.array([0.8, 0.3]),
                    coeffs=np.array([[0.4 * (1 + 1e-7)], [0.7]]))]
    cell = Cell(a=np.diag([8.0, 8.0, 8.0]),
                atom=[("He", np.full(3, 4.0)),
                      ("He", np.array([4.0, 4.0, 6.5]))],
                basis={"He": shells}, pseudo=None, mesh=np.array([16] * 3),
                unit="bohr", precision=1e-12).build()
    kpts = cell.get_kpts([1, 1, 2])
    ref = REFS["scf_device_near_dependent_he2"]
    return ref, cell, kpts, _port_df(cell, kpts, (9, 9, 9), ref)


def test_device_dropped_overlap_directions(near_dependent):
    """Penalised (dropped) overlap directions sort to the top of each
    spectrum; the occupation mask keys on the eigenvalues, not on column
    position."""
    ref, cell, kpts, df = near_dependent
    cutoff = 1e-4
    e_jax = ref["e_krhf"]
    mf0 = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10,
               ovlp_cutoff=cutoff, device="cpu")
    _, pen = orth_and_penalty(mf0.s1e, cutoff)
    assert (pen > 0).any(), "fixture no longer drops any direction"
    e0 = mf0.kernel()
    mf1 = DeviceKRHF(cell, kpts, df, verbose=0, conv_tol=1e-10,
                     ovlp_cutoff=cutoff, max_cycle=60, device="cpu")
    e1 = mf1.kernel()
    assert mf0.converged and mf1.converged
    np.testing.assert_allclose(e1, e0, atol=1e-7)
    np.testing.assert_allclose(e1, e_jax, atol=1e-7)
    mf2 = DeviceKRHF(cell, kpts, df, verbose=0, conv_tol=1e-10,
                     ovlp_cutoff=cutoff, smearing=1e-3, max_cycle=60,
                     device="cpu")
    e2 = mf2.kernel()
    assert mf2.converged
    np.testing.assert_allclose(e2, e0, atol=1e-6)


def test_device_f32_dropped_overlap_directions(near_dependent):
    """The float32 loop with dropped overlap directions: their diagonal
    entry is scaled to the Fock matrix's norm and the validity gate to its
    row-sum bound, so an eigensolver's backward error (eps ||A||) stays at
    the float32 floor.  The float32 loop lands within 2e-5 Ha of the
    float64 loop over the same float32 provider and of the host loop.
    (LAPACK on the CPU keeps the decoupled blocks apart whatever the
    entry; cuSOLVER does not, which tests/test_torch_gpu.py and the smoke
    script's float32 production run hold on the card.)"""
    _, cell, kpts, df64 = near_dependent
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 dtype=torch.float32, device="cpu").build(mask=df64.mask)
    kw = dict(verbose=0, conv_tol=1e-7, ovlp_cutoff=1e-4, max_cycle=60,
              device="cpu")
    mf64 = DeviceKRHF(cell, kpts, df, **kw)
    e64 = mf64.kernel()
    mf32 = DeviceKRHF(cell, kpts, df, dtype=torch.float32, **kw)
    e32 = mf32.kernel()
    _, pen = orth_and_penalty(mf32.s1e, 1e-4)
    assert (pen > 0).any(), "fixture no longer drops any direction"
    assert mf64.converged and mf32.converged
    assert abs(e32 - e64) < 2e-5
    e_host = KRHF(cell, kpts, df, dtype=torch.float32, **kw).kernel()
    assert abs(e32 - e_host) < 2e-5


def test_device_kuhf_bias_symmetry_breaking():
    """Stretched H2 with the on-site bias: the device loop reproduces the
    host loops' broken-symmetry solution."""
    cell = Cell(a=np.diag([10.0, 10.0, 14.0]),
                atom=[("H", (5.0, 5.0, 5.0)), ("H", (5.0, 5.0, 9.0))],
                basis={"H": [Shell(l=0, exps=np.array([1.0, 0.35]),
                                   coeffs=np.eye(2))]},
                pseudo="gth-pade", mesh=np.array([24, 24, 32]), unit="bohr",
                precision=1e-12).build()
    kpts = np.zeros((1, 3))
    ref = REFS["test_device_kuhf_bias_symmetry_breaking"]
    df = _port_df(cell, kpts, (9, 9, 11), ref)
    kw = dict(verbose=0, conv_tol=1e-9, init_spin={0: +1.0, 1: -1.0},
              spin_bias=0.5, bias_cycles=4)
    e_jax = ref["e_tot"]
    mf0 = KUHF(cell, kpts, df, device="cpu", **kw)
    e0 = mf0.kernel()
    mf1 = DeviceKUHF(cell, kpts, df, max_cycle=60, device="cpu", **kw)
    e1 = mf1.kernel()
    assert mf0.converged and mf1.converged
    np.testing.assert_allclose(e1, e0, atol=1e-7)
    np.testing.assert_allclose(e1, e_jax, atol=1e-7)
    pop = np.real(np.einsum("skmn,knm->sm", mf1.dm, mf1.s1e))
    assert abs(pop[0, :2].sum() - pop[1, :2].sum()) > 0.8


# ----------------------------------------------------------- tensor scf.core
def _diis_history(seed, m=6, n_live=4, L=40):
    rng = np.random.default_rng(seed)
    c = lambda *s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    valid = np.arange(m) < n_live
    return c(m, L), c(m, L), c(m, L), valid


def test_core_diis_and_adiis_match_jax():
    errs, focks, dms, valid = _diis_history(3)
    t = torch.from_numpy
    ref = recorded("scf_device/diis", lambda: jax_core.diis_extrapolate(
        jnp.asarray(errs), jnp.asarray(focks), jnp.asarray(valid), jnp))
    out = core.diis_extrapolate(t(errs), t(focks), t(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-11)
    # a masked slot carries garbage that must not leak in
    dms[~valid] = 1e6
    ref = recorded("scf_device/adiis", lambda: jax_core.adiis_coeffs(
        jnp.asarray(dms), jnp.asarray(focks), 2, jnp.asarray(valid), jnp,
        jax.lax.fori_loop))
    out = core.adiis_coeffs(t(dms), t(focks), 2, t(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-12)
    assert abs(float(out.sum()) - 1.0) < 1e-12
    assert (out.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("method", ["fermi", "gauss"])
def test_core_occupations_match_jax(method):
    rng = np.random.default_rng(5)
    e = np.sort(rng.standard_normal((4, 9)), axis=1)
    ok = np.ones_like(e, dtype=bool)
    ok[1, -2:] = False
    e[1, -2:] = 1e6                       # penalised slots
    t = torch.from_numpy
    f_j, s_j, mu_j = recorded(
        f"scf_device/smeared_occ/{method}", lambda: jax_core.smeared_occ(
            jnp.asarray(e), jnp.asarray(ok), 12.0, 0.05, method, jnp,
            jax.lax.fori_loop))
    f, s, mu = core.smeared_occ(t(e), t(ok), 12.0, 0.05, method)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), atol=1e-12)
    np.testing.assert_allclose(float(s), float(s_j), atol=1e-12)
    np.testing.assert_allclose(float(mu), float(mu_j), atol=1e-12)
    assert abs(float(f.sum()) - 12.0) < 1e-10
    occ_j = recorded(f"scf_device/aufbau_occ/{method}",
                     lambda: jax_core.aufbau_occ(jnp.asarray(e),
                                                 jnp.asarray(ok), 5, jnp))
    occ = core.aufbau_occ(t(e), t(ok), 5)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
