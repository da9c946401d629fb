"""SCF-level Coulomb truncation in the port against the JAX package (CPU,
float64): the truncated local pseudopotential, the ion-ion energy through
the truncated kernel (0d direct sum, 2d Ewald plus the exact difference
kernel), the probe-charge constant of a truncated kernel, and KRHF with
``trunc`` on the exact and the ISDF path.

Counterpart of tests/test_trunc_scf.py.  The host sums and the grid
potential run in both packages on the same inputs; the SCF energies of the
JAX package (H2/STO-3G in a 0d box, the H2 monolayer with 2d truncation
and exxdiv='ewald') are read from tests/data/jax_port_refs.json, written
by tools/jax_port_refs.py, and the port's are held to them to 1e-6 Ha,
with the JAX test's physics gates beside (the textbook -1.1167 Ha to
0.011, the vacuum independence to 2e-4).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.scf import integrals as jax_int
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.scf import KRHF
from fftisdf_tpu_torch.scf import integrals

REFS = json.loads((Path(__file__).parent / "data"
                   / "jax_port_refs.json").read_text())


def box_kw(L, ke=80.0, R=1.4):
    """H2 centred in an L cube (tools/jax_port_refs.py's h2_box)."""
    return dict(a=np.eye(3) * L, atom=[("H", (L / 2, L / 2, L / 2 - R / 2)),
                                       ("H", (L / 2, L / 2, L / 2 + R / 2))],
                basis="sto-3g", pseudo=None, ke_cutoff=ke, unit="bohr",
                precision=1e-12)


def slab_kw(lz, L=8.0, ke=60.0, R=1.4):
    """The H2 monolayer (tools/jax_port_refs.py's h2_slab)."""
    return dict(a=np.diag([L, L, lz]),
                atom=[("H", (L / 2 - R / 2, L / 2, lz / 2)),
                      ("H", (L / 2 + R / 2, L / 2, lz / 2))],
                basis="sto-3g", pseudo=None, ke_cutoff=ke, unit="bohr",
                precision=1e-12)


GTH_HE = dict(a=np.eye(3) * 10.0, atom=[("He", (5.0, 5.0, 5.0))],
              basis="sto-3g", pseudo="gth-pade", ke_cutoff=60.0,
              unit="bohr", precision=1e-12)


@pytest.mark.parametrize("kw,trunc", [
    (box_kw(12.5), ("0d", 6.25)), (slab_kw(12.0), ("2d", 6.0)),
    (GTH_HE, ("0d", 5.0))], ids=["box-0d", "slab-2d", "gth-0d"])
def test_nuc_and_vloc_trunc_match_jax(kw, trunc):
    """energy_nuc_trunc and the truncated vloc_on_grid (point nuclei and
    a GTH Gaussian charge) equal the JAX package's."""
    cell, cell_j = Cell(**kw).build(), JaxCell(**kw).build()
    e = integrals.energy_nuc_trunc(cell, trunc)
    assert abs(e - jax_int.energy_nuc_trunc(cell_j, trunc)) < 1e-12
    if trunc[0] == "0d" and cell.natm == 2:
        assert abs(e - 1.0 / 1.4) < 1e-12          # the direct sum
    v = integrals.vloc_on_grid(cell, trunc=trunc, device="cpu").numpy()
    v_j = np.asarray(jax_int.vloc_on_grid(cell_j, trunc=trunc))
    np.testing.assert_allclose(v, v_j, atol=1e-12 * np.abs(v_j).max())
    v_bare = integrals.vloc_on_grid(cell, device="cpu").numpy()
    assert np.abs(v_bare - v).max() > 1e-3


def test_ewald_trunc_2d_matches_jax():
    """_ewald_trunc_2d and _phi_diff_2d against the JAX package on the JAX
    test's net-charged pair and isolated cluster; the cluster's energy
    approaches the direct sum (1e-3), and a slab off the conventional
    geometry is refused."""
    a = np.diag([10.0, 10.0, 14.0])
    coords = np.array([[4.3, 5.0, 7.0], [5.7, 5.0, 7.0]])
    charges = np.array([1.0, 1.0])
    e = integrals._ewald_trunc_2d(coords, charges, a, 7.0)
    assert abs(e - jax_int._ewald_trunc_2d(coords, charges, a, 7.0)) < 1e-12
    d = coords[:, None, :] - coords[None, :, :]
    np.testing.assert_allclose(integrals._phi_diff_2d(d, a, 7.0),
                               jax_int._phi_diff_2d(d, a, 7.0), atol=1e-12)
    a2 = np.diag([60.0, 60.0, 16.0])
    c2 = np.array([[27.5, 29.0, 7.7], [30.0, 32.0, 8.4], [32.5, 28.5, 8.05]])
    q2 = np.array([1.0, 1.0, -2.0])
    e2 = integrals._ewald_trunc_2d(c2, q2, a2, 8.0)
    assert abs(e2 - jax_int._ewald_trunc_2d(c2, q2, a2, 8.0)) < 1e-12
    r = np.linalg.norm(c2[:, None, :] - c2[None, :, :], axis=-1)
    iu = np.triu_indices(3, 1)
    assert abs(e2 - np.sum(q2[iu[0]] * q2[iu[1]] / r[iu])) < 1e-3
    with pytest.raises(ValueError):
        integrals._ewald_trunc_2d(coords, charges, a, 6.0)


def test_madelung_trunc_matches_jax():
    """0d: exactly 0; 2d: the JAX package's constant for in-plane meshes;
    k-sampling along the slab normal is refused."""
    cell = Cell(**slab_kw(12.0)).build()
    cell_j = JaxCell(**slab_kw(12.0)).build()
    assert integrals.madelung_trunc(cell, (1, 1, 1), ("0d", 6.0)) == 0.0
    for kmesh in ((1, 1, 1), (2, 2, 1), (3, 1, 1)):
        m = integrals.madelung_trunc(cell, kmesh, ("2d", 6.0))
        assert abs(m - jax_int.madelung_trunc(cell_j, kmesh,
                                              ("2d", 6.0))) < 1e-12
    with pytest.raises(ValueError):
        integrals.madelung_trunc(cell, (1, 1, 2), ("2d", 6.0))


def test_krhf_h2_box_matches_jax():
    """KRHF(trunc='0d') on the exact path and on an ISDF build with the
    JAX package's points (trunc adopted from with_df) against the JAX
    package's energies (1e-6 Ha); the textbook -1.1167 Ha to 0.011 (the
    L = 9 box's periodised-AO tail); exxdiv='ewald' adds nothing in 0d."""
    ref = REFS["trunc_h2_box"]["9.0"]
    cell = Cell(**box_kw(9.0)).build()
    kpts = cell.get_kpts([1, 1, 1])
    mf = KRHF(cell, kpts, trunc="0d", verbose=0, device="cpu")
    assert mf.trunc[0] == "0d" and abs(mf.trunc[1] - 4.5) < 1e-10
    e = mf.kernel()
    assert mf.converged and abs(e - ref["e_exact"]) < 1e-6
    assert abs(e - (-1.1167)) < 0.011
    df = FFTISDF(cell, kpts, c0=25.0, m0=(15, 15, 15), verbose=0,
                 trunc="0d", device="cpu").build(mask=ref["mask"])
    mf2 = KRHF(cell, kpts, with_df=df, exxdiv="ewald", verbose=0,
               device="cpu")
    assert mf2.trunc == df.trunc and df.madelung() == 0.0
    assert abs(mf2.kernel() - ref["e_isdf"]) < 1e-6 and mf2.converged
    with pytest.raises(ValueError):
        KRHF(cell, kpts, with_df=df, trunc=("0d", 3.0), verbose=0,
             device="cpu")


def test_krhf_slab_2d_ewald_matches_jax():
    """The H2 monolayer with 2d truncation and exxdiv='ewald' (the
    truncated kernel's probe-charge constant, a negative q+G = 0 sample):
    each vacuum's energy within 1e-6 Ha of the JAX package's, independent
    of the vacuum to 2e-4, near the free molecule (0.011), and far from
    the untruncated energy."""
    ref = REFS["trunc_h2_slab"]
    es = {}
    for lz in (12.0, 16.0):
        cell = Cell(**slab_kw(lz)).build()
        mf = KRHF(cell, cell.get_kpts([1, 1, 1]), trunc="2d",
                  exxdiv="ewald", verbose=0, device="cpu")
        assert mf.trunc[0] == "2d" and abs(mf.trunc[1] - lz / 2) < 1e-10
        es[lz] = mf.kernel()
        assert mf.converged and abs(es[lz] - ref[str(lz)]) < 1e-6, lz
    assert abs(es[12.0] - es[16.0]) < 2e-4
    assert abs(es[12.0] - (-1.1167)) < 0.011
    assert abs(ref["bare_16.0"] - es[16.0]) > 1e-2


def test_fftisdf_exxdiv_ewald_trunc():
    """FFTISDF.get_jk(exxdiv='ewald') with a 2d kernel adds
    madelung_trunc S dm S, and the constant is the JAX package's."""
    cell = Cell(**slab_kw(12.0, ke=40.0)).build()
    kpts = cell.get_kpts([2, 1, 1])
    df = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 9), verbose=0, trunc="2d",
                 device="cpu").build()
    m = df.madelung()
    assert abs(m - jax_int.madelung_trunc(JaxCell(**slab_kw(
        12.0, ke=40.0)).build(), (2, 1, 1), df.trunc)) < 1e-12
    nao = cell.nao_nr()
    dm = np.stack([np.eye(nao, dtype=complex)] * len(kpts))
    _, vk0 = df.get_jk(dm)
    _, vk1 = df.get_jk(dm, exxdiv="ewald")
    s = df.get_ovlp()
    corr = m * (s @ torch.as_tensor(dm) @ s)
    np.testing.assert_allclose((vk1 - vk0).numpy(), corr.numpy(),
                               atol=1e-12)
