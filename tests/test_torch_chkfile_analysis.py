"""SCF checkpoints, population analysis and POSCAR output of the port
against the JAX package (CPU, float64).

Counterparts of tests/test_chkfile.py and tests/test_analysis.py with
their gates: a checkpoint round trip keeps energies, density and orbitals
(1e-14), a warm restart reconverges within 3 cycles to 1e-9 Ha, the
geometry is validated on load; populations sum to the electron count
(1e-8), charges to zero, and unrestricted moments to the spin imbalance
(1e-6).  A checkpoint written by either package's ``save_scf`` loads in the
other, key for key; the Mulliken populations and ``format_poscar`` run in
both packages on the same inputs.
"""
import numpy as np
import pytest

from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.scf import analysis as jax_analysis
from fftisdf_tpu.utils import serialization as jax_ser
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.scf import KRHF, KUHF, DeviceKUHF, analysis
from fftisdf_tpu_torch.utils.serialization import load_scf, save_scf
from test_torch_bands import he2_kw


@pytest.fixture(scope="module")
def he2_rhf():
    """A converged ISDF KRHF on the 4-AO He2 cell (1x1x2)."""
    cell = Cell(**he2_kw(Shell)).build()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 11), verbose=0,
                 device="cpu").build()
    mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10, device="cpu")
    mf.kernel()
    assert mf.converged
    return mf


def test_roundtrip_and_restart(he2_rhf, tmp_path):
    mf = he2_rhf
    path = str(tmp_path / "scf.npz")
    assert mf.save(path) == path
    data = load_scf(path, cell=mf.cell, kpts=mf.kpts)
    assert data["driver"] == "KRHF" and data["converged"]
    assert data["xc"] == "" and data["smearing"] == 0.0
    np.testing.assert_allclose(data["e_tot"], mf.e_tot, atol=1e-14)
    for name in ("dm", "mo_energy", "mo_coeff", "mo_occ"):
        np.testing.assert_allclose(data[name], getattr(mf, name),
                                   atol=1e-14)
    mf2 = KRHF(mf.cell, mf.kpts, mf.with_df, verbose=0, conv_tol=1e-10,
               max_cycle=3, device="cpu")
    e2 = mf2.kernel(dm0=mf2.load_chk(path))
    assert mf2.converged and mf2.cycles <= 3
    np.testing.assert_allclose(e2, mf.e_tot, atol=1e-9)


def test_geometry_validation(he2_rhf, tmp_path):
    mf = he2_rhf
    path = str(tmp_path / "scf.npz")
    mf.save(path)
    with pytest.raises(ValueError, match="k-points"):
        load_scf(path, kpts=mf.kpts + 0.1)
    cell2 = mf.cell.copy(mesh=np.asarray(mf.cell.mesh) + 2).build()
    with pytest.raises(ValueError, match="mesh"):
        load_scf(path, cell=cell2)
    with pytest.raises(ValueError, match="mesh"):
        KRHF(cell2, mf.kpts, mf.with_df, verbose=0,
             device="cpu").load_chk(path)
    with pytest.raises(ValueError):
        save_scf(str(tmp_path / "none.npz"),
                 KRHF(mf.cell, mf.kpts, mf.with_df, verbose=0,
                      device="cpu"))


def test_checkpoints_cross_packages(he2_rhf, tmp_path):
    """The JAX package's save_scf output loads in the port and restarts
    it; the port's loads in the JAX package with the same keys, values
    and geometry checks."""
    mf = he2_rhf
    p_jax, p_port = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ser.save_scf(p_jax, mf)
    mf.save(p_port)
    for path in (p_jax, p_port):
        a = load_scf(path, cell=mf.cell, kpts=mf.kpts)
        b = jax_ser.load_scf(path, cell=mf.cell, kpts=mf.kpts)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with np.load(p_jax) as fj, np.load(p_port) as fp:
        assert sorted(fj.files) == sorted(fp.files)
    with pytest.raises(ValueError, match="k-points"):
        jax_ser.load_scf(p_port, kpts=mf.kpts + 0.1)
    mf2 = KRHF(mf.cell, mf.kpts, mf.with_df, verbose=0, conv_tol=1e-10,
               max_cycle=3, device="cpu")
    assert abs(mf2.kernel(dm0=mf2.load_chk(p_jax)) - mf.e_tot) < 1e-9


def test_unrestricted_checkpoint_and_moments(he2_rhf, tmp_path):
    """KUHF with a spin imbalance (Fermi smearing): the moments sum to
    na - nb and the charges to zero (1e-6), equal to the JAX package's
    analysis of the same density; a DeviceKUHF checkpoint carries its
    driver name and spin axis."""
    mf0 = he2_rhf
    cell = mf0.cell.copy(spin=2).build()
    mf = KUHF(cell, mf0.kpts, mf0.with_df, verbose=0, conv_tol=1e-8,
              smearing=5e-3, max_cycle=60, device="cpu")
    mf.kernel()
    charges, moments = analysis.atom_charges_and_moments(cell, mf.dm,
                                                         mf.s1e)
    na, nb = mf.nocc_ab
    np.testing.assert_allclose(moments.sum(), na - nb, atol=1e-6)
    np.testing.assert_allclose(charges.sum(), 0.0, atol=1e-6)
    cj, mj = jax_analysis.atom_charges_and_moments(cell, mf.dm, mf.s1e)
    np.testing.assert_allclose(charges, cj, atol=1e-12)
    np.testing.assert_allclose(moments, mj, atol=1e-12)
    mfd = DeviceKUHF(cell, mf0.kpts, mf0.with_df, verbose=0, conv_tol=1e-8,
                     smearing=5e-3, max_cycle=60, device="cpu")
    mfd.kernel()
    path = str(tmp_path / "uscf.npz")
    mfd.save(path)
    data = jax_ser.load_scf(path)
    assert data["driver"] == "DeviceKUHF"
    assert data["dm"].shape == (2,) + mf0.dm.shape
    assert data["mu"].shape == (2,)
    np.testing.assert_allclose(data["e_tot"], mfd.e_tot, atol=1e-14)


def test_populations_match_jax(he2_rhf, capsys):
    """Mulliken and Loewdin populations equal the JAX package's and sum to
    the electron count, the charges to zero; equivalent atoms carry equal
    charge; mulliken() prints per atom."""
    mf = he2_rhf
    pop = analysis.ao_populations(mf.cell, mf.dm, mf.s1e)
    np.testing.assert_allclose(
        pop, jax_analysis.ao_populations(mf.cell, mf.dm, mf.s1e),
        atol=1e-13)
    np.testing.assert_allclose(pop.sum(), mf.cell.nelectron, atol=1e-8)
    charges, moments = analysis.mulliken(mf)
    assert "mulliken analysis" in capsys.readouterr().out
    np.testing.assert_allclose(charges.sum(), 0.0, atol=1e-8)
    np.testing.assert_allclose(charges[0], charges[1], atol=1e-5)
    np.testing.assert_allclose(moments, 0.0, atol=1e-12)
    cj, _ = jax_analysis.mulliken(mf, log=False)
    np.testing.assert_allclose(charges, cj, atol=1e-13)
    pop_l = analysis.ao_populations(mf.cell, mf.dm, mf.s1e,
                                    scheme="loewdin")
    np.testing.assert_allclose(
        pop_l, jax_analysis.ao_populations(mf.cell, mf.dm, mf.s1e,
                                           scheme="loewdin"), atol=1e-13)
    np.testing.assert_allclose(pop_l.sum(), mf.cell.nelectron, atol=1e-8)
    charges_l, _ = analysis.mulliken(mf, scheme="loewdin", log=False)
    np.testing.assert_allclose(charges_l.sum(), 0.0, atol=1e-8)
    with pytest.raises(ValueError):
        analysis.ao_populations(mf.cell, mf.dm, mf.s1e, scheme="bader")


@pytest.mark.parametrize("build", ["nio_afm", "bulk_diamond",
                                   "bulk_rocksalt"])
def test_format_poscar_matches_jax(build):
    """format_poscar's text equals the JAX package's, and parse_poscar
    reads the structure back (1e-9 Angstrom)."""
    lat, atoms = getattr(structure, build)()
    text = structure.format_poscar(lat, atoms, comment=build)
    assert text == jax_structure.format_poscar(lat, atoms, comment=build)
    lat2, atoms2 = structure.parse_poscar(text)
    np.testing.assert_allclose(lat2, lat, atol=1e-9)
    assert sorted(s for s, _ in atoms2) == sorted(s for s, _ in atoms)
    for sym in {s for s, _ in atoms}:
        xa = np.array([x for s, x in atoms if s == sym])
        xb = np.array([x for s, x in atoms2 if s == sym])
        np.testing.assert_allclose(xb, xa, atol=1e-9)
