"""The port's device-resident SCF loop (``scf.device``) and its tensor SCF
numerics (``scf.core``) against the port's host loops and the JAX package,
on the fixtures of tests/test_scf_device.py (CPU, f64).

The device loop runs here on CPU tensors; the tolerances are
tests/test_scf_device.py's.  The port is given the JAX package's
interpolation points (``build(mask=...)``), so that its energies can be
held against the JAX package's host energies too.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.isdf import FFTISDF as JaxISDF
from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.lattice.cell import Cell as JaxCell, Shell as JaxShell
from fftisdf_tpu.scf import KRHF as JaxKRHF, KUHF as JaxKUHF
from fftisdf_tpu.scf import core as jax_core
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.scf import KRHF, KUHF, DeviceKRHF, DeviceKUHF
from fftisdf_tpu_torch.scf import core
from fftisdf_tpu_torch.scf.device import orth_and_penalty
from torch_test_threads import two_torch_threads  # noqa: F401


def _pair(cell_j, cell, kpts, m0):
    """(JAX package's df, port's df on the JAX mask), c0 40."""
    df_j = JaxISDF(cell_j, kpts, c0=40.0, m0=m0, verbose=0).build()
    df = FFTISDF(cell, kpts, c0=40.0, m0=m0, verbose=0,
                 device="cpu").build(mask=np.asarray(df_j.mask))
    return df_j, df


@pytest.fixture(scope="module")
def diamond():
    args = structure.bulk_diamond()
    kw = dict(basis="gth-szv", pseudo="gth-pade", ke_cutoff=50.0)
    cell_j = jax_structure.to_cell(*jax_structure.bulk_diamond(), **kw)
    cell = structure.to_cell(*args, **kw)
    kpts = cell.get_kpts([1, 1, 2])
    return (cell_j, cell, kpts) + _pair(cell_j, cell, kpts, (9, 9, 9))


def test_device_krhf_matches_host(diamond):
    cell_j, cell, kpts, df_j, df = diamond
    e_jax = JaxKRHF(cell_j, kpts, with_df=df_j, verbose=0,
                    conv_tol=1e-10).kernel()
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
    cell_j, cell, kpts, df_j, df = diamond
    mf_j = JaxKUHF(cell_j, kpts, with_df=df_j, verbose=0, conv_tol=1e-10,
                   smearing=5e-3)
    mf_j.kernel()
    mf0 = KUHF(cell, kpts, df, verbose=0, conv_tol=1e-10, smearing=5e-3,
               device="cpu")
    e0 = mf0.kernel()
    mf1 = DeviceKUHF(cell, kpts, df, verbose=0, conv_tol=1e-10,
                     smearing=5e-3, max_cycle=60, device="cpu")
    e1 = mf1.kernel()
    assert mf0.converged and mf1.converged
    np.testing.assert_allclose(e1, e0, atol=3e-8)
    np.testing.assert_allclose(mf1.e_free, mf0.e_free, atol=3e-8)
    np.testing.assert_allclose(e1, mf_j.e_tot, atol=3e-8)
    np.testing.assert_allclose(mf1.e_free, mf_j.e_free, atol=3e-8)
    with pytest.raises(NotImplementedError):
        DeviceKUHF(cell, kpts, df, verbose=0, level_shift=0.1,
                   device="cpu").kernel()
    with pytest.raises(NotImplementedError):
        DeviceKUHF(cell, kpts, df, verbose=0, exxdiv="ewald",
                   device="cpu").kernel()


def _near_dependent_cells():
    """He2 with two nearly identical s shells per atom (near-singular
    overlap), built by each package's Cell."""
    def shells(shell_cls):
        return [shell_cls(l=0, exps=np.array([0.8, 0.3]),
                          coeffs=np.array([[0.4], [0.7]])),
                shell_cls(l=0, exps=np.array([0.8, 0.3]),
                          coeffs=np.array([[0.4 * (1 + 1e-7)], [0.7]]))]

    kw = dict(a=np.diag([8.0, 8.0, 8.0]),
              atom=[("He", np.full(3, 4.0)),
                    ("He", np.array([4.0, 4.0, 6.5]))],
              pseudo=None, mesh=np.array([16] * 3), unit="bohr",
              precision=1e-12)
    return (JaxCell(basis={"He": shells(JaxShell)}, **kw).build(),
            Cell(basis={"He": shells(Shell)}, **kw).build())


def test_device_dropped_overlap_directions():
    """Penalised (dropped) overlap directions sort to the top of each
    spectrum; the occupation mask keys on the eigenvalues, not on column
    position."""
    cell_j, cell = _near_dependent_cells()
    kpts = cell.get_kpts([1, 1, 2])
    df_j, df = _pair(cell_j, cell, kpts, (9, 9, 9))
    cutoff = 1e-4
    e_jax = JaxKRHF(cell_j, kpts, with_df=df_j, verbose=0, conv_tol=1e-10,
                    ovlp_cutoff=cutoff).kernel()
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


def test_device_f32_dropped_overlap_directions():
    """The float32 loop with dropped overlap directions: their diagonal
    entry is scaled to the Fock matrix's norm and the validity gate to its
    row-sum bound, so an eigensolver's backward error (eps ||A||) stays at
    the float32 floor.  The float32 loop lands within 2e-5 Ha of the
    float64 loop over the same float32 provider and of the host loop.
    (LAPACK on the CPU keeps the decoupled blocks apart whatever the
    entry; cuSOLVER does not, which tests/test_torch_gpu.py and the smoke
    script's float32 production run hold on the card.)"""
    cell_j, cell = _near_dependent_cells()
    kpts = cell.get_kpts([1, 1, 2])
    _, df64 = _pair(cell_j, cell, kpts, (9, 9, 9))
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
    def h2(cell_cls, shell_cls):
        return cell_cls(
            a=np.diag([10.0, 10.0, 14.0]),
            atom=[("H", (5.0, 5.0, 5.0)), ("H", (5.0, 5.0, 9.0))],
            basis={"H": [shell_cls(l=0, exps=np.array([1.0, 0.35]),
                                   coeffs=np.eye(2))]},
            pseudo="gth-pade", mesh=np.array([24, 24, 32]), unit="bohr",
            precision=1e-12).build()

    cell_j, cell = h2(JaxCell, JaxShell), h2(Cell, Shell)
    kpts = np.zeros((1, 3))
    df_j = JaxISDF(cell_j, kpts, c0=40.0, m0=(9, 9, 11), verbose=0).build()
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 11), verbose=0,
                 device="cpu").build(mask=np.asarray(df_j.mask))
    kw = dict(verbose=0, conv_tol=1e-9, init_spin={0: +1.0, 1: -1.0},
              spin_bias=0.5, bias_cycles=4)
    e_jax = JaxKUHF(cell_j, kpts, with_df=df_j, **kw).kernel()
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
    ref = jax_core.diis_extrapolate(jnp.asarray(errs), jnp.asarray(focks),
                                    jnp.asarray(valid), jnp)
    out = core.diis_extrapolate(t(errs), t(focks), t(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-11)
    # a masked slot carries garbage that must not leak in
    dms[~valid] = 1e6
    ref = jax_core.adiis_coeffs(jnp.asarray(dms), jnp.asarray(focks), 2,
                                jnp.asarray(valid), jnp, jax.lax.fori_loop)
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
    f_j, s_j, mu_j = jax_core.smeared_occ(jnp.asarray(e), jnp.asarray(ok),
                                          12.0, 0.05, method, jnp,
                                          jax.lax.fori_loop)
    f, s, mu = core.smeared_occ(t(e), t(ok), 12.0, 0.05, method)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), atol=1e-12)
    np.testing.assert_allclose(float(s), float(s_j), atol=1e-12)
    np.testing.assert_allclose(float(mu), float(mu_j), atol=1e-12)
    assert abs(float(f.sum()) - 12.0) < 1e-10
    occ_j = jax_core.aufbau_occ(jnp.asarray(e), jnp.asarray(ok), 5, jnp)
    occ = core.aufbau_occ(t(e), t(ok), 5)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_j))
