"""The port's own host layer against the JAX package's, and the port's
default device.

The port keeps its own copy of the cell, k-point, structure, basis-table
and native-engine modules.  Built from the same arguments, its cell must
equal the JAX package's exactly or to 1e-14: lattice, atoms, mesh, basis
shells, pseudopotentials, G vectors, k-points, the k-mesh, the phase
matrix, and the native image enumeration and real-space Ewald sum.

Every entry point of the port runs on CUDA unless the caller asks for the
CPU; where CUDA is absent it raises instead of falling back.
"""
import numpy as np
import pytest
import torch

from fftisdf_tpu import native as jax_native
from fftisdf_tpu.lattice import kpoints as jax_kpoints
from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu_torch import native
from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.isdf.kpoint import select_interpolation_points
from fftisdf_tpu_torch.lattice import kpoints, structure
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.scf import KRHF, KUHF
from fftisdf_tpu_torch.utils.device import resolve_device

HE2 = dict(a=np.diag([5.0, 5.0, 7.0]),
           atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
           basis="sto-3g", pseudo=None, mesh=np.array([11, 11, 15]),
           unit="bohr", precision=1e-10)


def _from_maker(maker, **kw):
    return (jax_structure.to_cell(*getattr(jax_structure, maker)(), **kw),
            structure.to_cell(*getattr(structure, maker)(), **kw))


CELLS = {
    "nio_afm_szv_ke100": (lambda: _from_maker(
        "nio_afm", basis="gth-szv", pseudo="gth-pade", ke_cutoff=100.0,
        exp_to_discard=0.1), [4, 4, 4]),
    "diamond_szv_ke50": (lambda: _from_maker(
        "bulk_diamond", basis="gth-szv", pseudo="gth-pade", ke_cutoff=50.0),
        [1, 1, 2]),
    "he2_sto3g": (lambda: (JaxCell(**HE2).build(), Cell(**HE2).build()),
                  [1, 2, 3]),
}


def _same(a, b, tol=1e-14):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.size:
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_port_cell_equals_jax_cell(name):
    make, kmesh = CELLS[name]
    cell_j, cell = make()
    assert type(cell).__module__.startswith("fftisdf_tpu_torch.")
    _same(cell.a, cell_j.a)
    _same(cell.atom_coords(), cell_j.atom_coords())
    assert cell.atom_symbols() == cell_j.atom_symbols()
    np.testing.assert_array_equal(cell.mesh, cell_j.mesh)
    assert cell.nao_nr() == cell_j.nao_nr()
    assert cell.nelectron == cell_j.nelectron
    shells = list(cell.shells())
    shells_j = list(cell_j.shells())
    assert len(shells) == len(shells_j)
    for (ia, sym, _, sh), (ia_j, sym_j, _, sh_j) in zip(shells, shells_j):
        assert (ia, sym, sh.l, sh.rpow) == (ia_j, sym_j, sh_j.l, sh_j.rpow)
        np.testing.assert_array_equal(sh.exps, sh_j.exps)
        np.testing.assert_array_equal(sh.coeffs, sh_j.coeffs)
    assert sorted(cell._pseudo) == sorted(cell_j._pseudo)
    for sym, ps in cell._pseudo.items():
        ps_j = cell_j._pseudo[sym]
        assert (ps.zion, ps.rloc) == (ps_j.zion, ps_j.rloc)
        np.testing.assert_array_equal(ps.cloc, ps_j.cloc)
        assert len(ps.projectors) == len(ps_j.projectors)
        for (l, rl, h), (l_j, rl_j, h_j) in zip(ps.projectors,
                                                ps_j.projectors):
            assert (l, rl) == (l_j, rl_j)
            np.testing.assert_array_equal(h, h_j)
    _same(cell.get_Gv(), cell_j.get_Gv())
    kpts = cell.get_kpts(kmesh)
    _same(kpts, cell_j.get_kpts(kmesh))
    mesh_k = kpoints.kpts_to_kmesh(cell, kpts)
    np.testing.assert_array_equal(mesh_k,
                                  jax_kpoints.kpts_to_kmesh(cell_j, kpts))
    np.testing.assert_array_equal(mesh_k, kmesh)
    _same(kpoints.get_phase(cell, kpts, kmesh),
          jax_kpoints.get_phase(cell_j, kpts, kmesh))
    s = cell.get_scaled_kpts(kpts)
    for k in range(len(kpts)):
        assert kpoints.member(-s[k], s, strict=False) == \
            jax_kpoints.member(-s[k], s, strict=False)
    # the native engines, on the same inputs
    coords, charges = cell.atom_coords(), cell.atom_charges()
    _same(charges, cell_j.atom_charges())
    ts = np.stack(np.meshgrid(*[np.arange(-2, 3)] * 3, indexing="ij"),
                  -1).reshape(-1, 3).astype(float) @ cell.a
    eta = np.pi / cell.vol ** (2.0 / 3.0)
    e = native.ewald_real(coords, charges, ts, eta)
    assert e is not None and np.isfinite(e)
    _same(e, jax_native.ewald_real(coords, charges, ts, eta))
    center = coords[0]
    images = native.enumerate_images(cell.a, center, cell.a.sum(0) / 2, 12.0,
                                     np.array([4, 4, 4]))
    _same(images, jax_native.enumerate_images(
        cell.a, center, cell.a.sum(0) / 2, 12.0, np.array([4, 4, 4])),
        tol=0.0)


@pytest.fixture
def no_cuda(monkeypatch):
    """A host without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    """With no ``device`` the entry points ask for CUDA, and raise where it
    is absent: nothing falls back to the CPU."""
    cell = Cell(**HE2).build()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=8.0, m0=(7, 7, 9), verbose=0, device="cpu")
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device(),
        lambda: FFTISDF(cell, kpts, c0=8.0, m0=(7, 7, 9), verbose=0),
        lambda: KRHF(cell, kpts, df, verbose=0),
        lambda: KUHF(cell, kpts, df, verbose=0),
        lambda: select_interpolation_points(cell, kpts, (7, 7, 9), 8.0),
        lambda: make_evaluator(cell, kpts=kpts),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("maker", ["bulk_diamond", "bulk_rocksalt",
                                   "nio_afm"])
def test_port_structures_equal_jax(maker):
    """The structure constructors and the POSCAR parser give the JAX
    package's numbers."""
    lat_j, atoms_j = getattr(jax_structure, maker)()
    lat, atoms = getattr(structure, maker)()
    np.testing.assert_array_equal(lat, lat_j)
    assert [s for s, _ in atoms] == [s for s, _ in atoms_j]
    np.testing.assert_array_equal([x for _, x in atoms],
                                  [x for _, x in atoms_j])
    text = jax_structure.format_poscar(lat_j, atoms_j)
    lat_p, atoms_p = structure.parse_poscar(text)
    lat_pj, atoms_pj = jax_structure.parse_poscar(text)
    np.testing.assert_array_equal(lat_p, lat_pj)
    assert [s for s, _ in atoms_p] == [s for s, _ in atoms_pj]
    np.testing.assert_array_equal([x for _, x in atoms_p],
                                  [x for _, x in atoms_pj])


@pytest.mark.parametrize("kmesh", [[2, 2, 2], [3, 1, 2]])
def test_kconserv_tables_equal_jax_native(kmesh):
    """The port's numpy get_kconserv2/3 equal the JAX package's tables,
    which its native engine builds (``native.build_kconserv``, shipped
    without source, so not ported)."""
    cell_j, cell = _from_maker("bulk_diamond", basis="gth-szv",
                               pseudo="gth-pade", ke_cutoff=30.0)
    kpts = cell.get_kpts(kmesh)
    k2, k3 = jax_native.build_kconserv(cell_j.get_scaled_kpts(kpts))
    np.testing.assert_array_equal(kpoints.get_kconserv2(cell, kpts), k2)
    np.testing.assert_array_equal(kpoints.get_kconserv3(cell, kpts), k3)
    np.testing.assert_array_equal(jax_kpoints.get_kconserv3(cell_j, kpts),
                                  k3)
