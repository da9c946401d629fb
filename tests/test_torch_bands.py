"""Band k-points in the port against the JAX package (CPU, float64): the
exact plane-wave band path (``pw.jk`` with ``ao_band``/``kpts_band``/
``g0_argmin_thresh``), the ISDF band serve (``isdf.bands`` through
``FFTISDF.get_jk(kpts_band=)``) and ``KRHF``/``KUHF.get_bands``.

Counterparts of tests/test_isdf_bands.py and of the band part of
tests/test_exxdiv_bands.py, with their gates: ISDF band J/K against the
exact band path to 1e-8 at full rank and to 1e-3 of the scale compressed,
band energies at the mesh points equal to the eigenvalues of the converged
Fock to 1e-8 (with exxdiv None and 'ewald').  The exact band path and the
kernel rule run in both packages on the same inputs; the band energies of
the JAX package's SCFs are read from tests/data/jax_port_refs.json
(``tools/jax_port_refs.py``).
"""
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest

from fftisdf_tpu.isdf import bands as jax_bands
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.lattice.cell import Shell as JaxShell
from fftisdf_tpu.pw import jk as jax_pw_jk
from fftisdf_tpu_torch.basis.eval import eval_ao_kpts
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.isdf import bands
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.pw import jk as pw_jk
from fftisdf_tpu_torch.scf import KRHF, KUHF
from fftisdf_tpu_torch.scf.hf import _eigh_gen
from test_isdf_kpoint import trs_dm
from torch_test_threads import two_torch_threads  # noqa: F401

REFS = json.loads((Path(__file__).parent / "data"
                   / "jax_port_refs.json").read_text())


def he2_kw(shell_cls):
    """tests/test_isdf_bands.py's He2 (tools/jax_port_refs.py's
    he2_bands_cell)."""
    return dict(a=np.diag([5.0, 5.0, 7.0]),
                atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
                basis={"He": [shell_cls(l=0, exps=np.array([1.0, 0.35]),
                                        coeffs=np.eye(2))]},
                pseudo=None, mesh=np.array([12, 12, 16]), unit="bohr",
                precision=1e-12)


@pytest.fixture(scope="module")
def he2():
    """(cell, kpts, band points: two off the mesh and kpts[1], density)."""
    cell = Cell(**he2_kw(Shell)).build()
    kpts = cell.get_kpts([1, 1, 2])
    b = cell.reciprocal_vectors()
    kband = np.array([0.17 * b[2], 0.33 * b[0] + 0.41 * b[2], kpts[1]])
    return cell, kpts, kband, trs_dm(cell, kpts, cell.nao_nr())[0]


def _pw_band_jk(cell, kpts, kband, dm):
    coords = cell.gen_uniform_grids()
    ao = eval_ao_kpts(cell, coords, kpts, device="cpu")
    aob = eval_ao_kpts(cell, coords, kband, device="cpu")
    thr = bands._qlat_dmin2(cell, [1, 1, 2])
    vj = pw_jk.get_j_kpts(cell, dm, ao, ao_band=aob)
    vk = pw_jk.get_k_kpts(cell, dm, ao, kpts, coords=coords, ao_band=aob,
                          kpts_band=kband, g0_argmin_thresh=thr)
    return vj.numpy(), vk.numpy(), ao, aob, thr


def test_band_kernel_rule_matches_jax(he2):
    """_qlat_dmin2 and the argmin exclusion of _band_coulG: at a mesh
    point exactly the q+G = 0 sample goes, off the mesh exactly one.  An
    off-diagonal mesh pair sits at the threshold in exact arithmetic and
    keeps every sample in the port; the JAX package compares it strictly
    and may drop one by rounding (ROADMAP section 3)."""
    cell, kpts, kband, _ = he2
    cell_j = JaxCell(**he2_kw(JaxShell)).build()
    for kmesh in ([1, 1, 2], [2, 3, 1]):
        assert bands._qlat_dmin2(cell, kmesh) == jax_bands._qlat_dmin2(
            cell_j, kmesh)
    gv = cell.get_Gv()
    thr = bands._qlat_dmin2(cell, [1, 1, 2])
    for q in [kpts[1] - kb for kb in kband] + [kpts[0] - kband[0]]:
        cg = bands._band_coulG(cell, q, gv, thr)
        np.testing.assert_array_equal(cg,
                                      jax_bands._band_coulG(cell_j, q, gv,
                                                            thr))
        assert (cg == 0).sum() <= 1
    assert (bands._band_coulG(cell, kpts[0] - kpts[1], gv, thr) > 0).all()


def test_pw_band_path_matches_jax(he2):
    """The exact band path (band rows against the mesh density, argmin
    exclusion) equals the JAX package's off the mesh (1e-12), and the
    mesh serve at a mesh point."""
    cell, kpts, kband, dm = he2
    vj, vk, ao, aob, thr = _pw_band_jk(cell, kpts, kband, dm)
    assert vj.shape == vk.shape == (3, 4, 4)
    cell_j = JaxCell(**he2_kw(JaxShell)).build()
    aoj, aobj = jnp.asarray(ao.numpy()), jnp.asarray(aob.numpy()[:2])
    vj_j = jax_pw_jk.get_j_kpts(cell_j, jnp.asarray(dm), aoj, ao_band=aobj)
    vk_j = jax_pw_jk.get_k_kpts(cell_j, jnp.asarray(dm), aoj, kpts,
                                coords=cell.gen_uniform_grids(),
                                ao_band=aobj, kpts_band=kband[:2],
                                g0_argmin_thresh=thr)
    vj, vk, vj_band, vk_band = vj[:2], vk[:2], vj, vk
    np.testing.assert_allclose(vj, np.asarray(vj_j), atol=1e-12)
    np.testing.assert_allclose(vk, np.asarray(vk_j), atol=1e-12)
    # at the mesh point the band path is the mesh serve
    vj_m, vk_m = (t.numpy() for t in pw_jk.get_jk_kpts(
        cell, dm, ao, kpts, coords=cell.gen_uniform_grids()))
    np.testing.assert_allclose(vj_band[2], vj_m[1], atol=1e-12)
    np.testing.assert_allclose(vk_band[2], vk_m[1], atol=1e-12)


@pytest.mark.parametrize("regime", ["full", "compressed"])
def test_isdf_bands_match_pw(he2, regime):
    """ISDF band J/K (per-pair re-fits of the product state) against the
    exact band path: 1e-8 at full rank, 1e-3 of the scale compressed; a
    set axis serves each set.  The full-rank build takes the JAX package's
    interpolation points: at select_tol 1e-20 the numerical rank of the
    pair gram is decided by rounding (the port stops at 27 points, the JAX
    package at 41), and the 1e-8 gate is the JAX package's on its own
    points."""
    cell, kpts, kband, dm = he2
    kw = (dict(c0=60.0, m0=tuple(cell.mesh), select_tol=1e-20, rcond=1e-12)
          if regime == "full" else dict(c0=10.0, m0=(7, 7, 11)))
    mask = REFS["bands_he2"]["mask_full"] if regime == "full" else None
    df = FFTISDF(cell, kpts, verbose=0, device="cpu", **kw).build(mask=mask)
    vj_ref, vk_ref, *_ = _pw_band_jk(cell, kpts, kband, dm)
    vj, vk = df.get_jk(dm, kpts_band=kband)
    tol = 1e-8 if regime == "full" else 1e-3 * max(1.0,
                                                   np.abs(vk_ref).max())
    np.testing.assert_allclose(vj.numpy(), vj_ref, atol=tol)
    np.testing.assert_allclose(vk.numpy(), vk_ref, atol=tol)
    if regime == "compressed":
        vj2, vk2 = df.get_jk(np.stack([dm, 0.5 * dm]), kpts_band=kband[:1])
        assert vj2.shape == (2, 1, 4, 4)
        np.testing.assert_allclose(vk2[1].numpy(), 0.5 * vk.numpy()[:1],
                                   atol=1e-12)
        vj3, vk3 = df.get_jk(dm, kpts_band=kband[:1], with_k=False)
        assert vk3 is None
        np.testing.assert_allclose(vj3.numpy(), vj.numpy()[:1], atol=1e-12)


def _mesh_consistency(mf, es, atol=1e-8):
    """Band energies at the mesh k-points against the eigenvalues of the
    converged Fock (1e-8 on the exact path)."""
    fock, _, _ = mf.get_fock(mf.dm)
    if fock.ndim == 4:
        for s in range(2):
            for k in range(len(mf.kpts)):
                e_ref, _ = _eigh_gen(fock[s, k], mf.s1e[k],
                                     cutoff=mf.ovlp_cutoff)
                np.testing.assert_allclose(es[s][k], e_ref, atol=atol)
        return
    for k in range(len(mf.kpts)):
        e_ref, _ = _eigh_gen(fock[k], mf.s1e[k], cutoff=mf.ovlp_cutoff)
        np.testing.assert_allclose(es[k], e_ref, atol=atol)


def test_get_bands_exact_krhf_matches_jax(he2):
    """Exact-path KRHF: band energies at the off-mesh points equal the
    JAX package's (1e-6 Ha; the SCF itself to 1e-8), at the mesh points
    the converged Fock's with exxdiv None and 'ewald'; off-mesh points
    with 'ewald' are refused."""
    cell, kpts, kband, _ = he2
    ref = REFS["bands_he2"]
    mf = KRHF(cell, kpts, verbose=0, conv_tol=1e-12, device="cpu")
    assert abs(mf.kernel() - ref["e_krhf"]) < 1e-8 and mf.converged
    es, cs = mf.get_bands(kband)
    assert len(es) == len(cs) == 3
    np.testing.assert_allclose(np.asarray(es)[:2],
                               np.asarray(ref["bands_krhf"])[:2], atol=1e-6)
    _mesh_consistency(mf, mf.get_bands(kpts)[0])
    mf.exxdiv = "ewald"
    _mesh_consistency(mf, mf.get_bands(kpts)[0])
    with pytest.raises(ValueError):
        mf.get_bands(kband)


def test_get_bands_isdf_kuhf_matches_jax(he2):
    """ISDF-backed KUHF on the JAX package's points: per-spin band
    energies off the mesh equal the JAX package's (1e-6 Ha); the full-grid
    AO tensor is never built on this path.  At the mesh points the band
    serve re-fits the single (band, k2) pair where the SCF's serve fits
    the whole q sector, so the two agree to the compression error, not to
    1e-8 (measured 1.1e-6 Ha here): 1e-5 Ha."""
    cell, kpts, kband, _ = he2
    ref = REFS["bands_he2"]
    df = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 11), verbose=0,
                 device="cpu").build(mask=ref["mask"])
    mf = KUHF(cell, kpts, df, verbose=0, conv_tol=1e-12, device="cpu")
    assert abs(mf.kernel() - ref["e_kuhf"]) < 1e-8 and mf.converged
    es, _ = mf.get_bands(kband)
    assert len(es) == 2 and len(es[0]) == 3
    np.testing.assert_allclose(np.asarray(es)[:, :2],
                               np.asarray(ref["bands_kuhf"])[:, :2],
                               atol=1e-6)
    _mesh_consistency(mf, mf.get_bands(kpts)[0], atol=1e-5)
    assert mf._ao is None
