"""The port's remaining ISDF tools against the JAX package (CPU, float64):
the Γ-point / global fit (``isdf.gamma``), the AO -> MO transforms
(``isdf.ao2mo``), LS-THC (``isdf.thc``) on uniform and Becke grids
(``lattice.becke``), ``linalg.solvers.whiten_basis`` and
``basis.eval.eval_ao_gamma``.

Counterparts of tests/test_isdf_gamma.py, tests/test_thc_ao2mo.py,
tests/test_becke.py and tests/test_whiten_multisector.py, with their
gates.  Cheap functions run both packages on the same inputs; the JAX
package's LS-THC error reports are read from tests/data/jax_port_refs.json
(``tools/jax_port_refs.py``).  Selection ties on these symmetric cells are
broken differently by the two packages, so the fits are held to the exact
oracle and to each other's gates, and functions downstream of a fit get
the same fit.
"""
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.basis.eval import eval_ao_gamma as jax_eval_gamma
from fftisdf_tpu.isdf import FFTISDF as JaxISDF
from fftisdf_tpu.isdf import ao2mo as jax_ao2mo
from fftisdf_tpu.isdf import gamma as jax_gamma
from fftisdf_tpu.isdf import thc as jax_thc
from fftisdf_tpu.lattice import becke as jax_becke
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.linalg.solvers import whiten_basis as jax_whiten
from jax_records import recorded
from fftisdf_tpu_torch.basis.eval import eval_ao_gamma, eval_ao_kpts
from fftisdf_tpu_torch.isdf import FFTISDF, ao2mo, gamma
from fftisdf_tpu_torch.isdf.kpoint import _stripe_quartic
from fftisdf_tpu_torch.isdf.thc import LSTHC, pw_cderi
from fftisdf_tpu_torch.lattice import becke
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.linalg.solvers import whiten_basis
from fftisdf_tpu_torch.pw import get_eri_from_ao

REFS = json.loads((Path(__file__).parent / "data"
                   / "jax_port_refs.json").read_text())


def he2_kw(a=(5.0, 5.0, 7.0), mesh=(9, 9, 11)):
    """He2 STO-3G (tests/test_thc_ao2mo.py; tools/jax_port_refs.py's
    lsthc_he2_cell)."""
    return dict(a=np.diag(a), atom=[("He", (a[0] / 2, a[1] / 2, 2.0)),
                                    ("He", (a[0] / 2, a[1] / 2, 4.5))],
                basis="sto-3g", pseudo=None, mesh=np.array(mesh),
                unit="bohr", precision=1e-12)


GAMMA_KW = dict(a=np.diag([4.0, 4.0, 6.0]),
                atom=[("He", (2.0, 2.0, 2.0)), ("He", (2.0, 2.0, 4.0))],
                basis="sto-3g", pseudo=None, mesh=np.array([9, 9, 11]),
                unit="bohr", precision=1e-12)
# a box wide enough that the Becke partition reaches few lattice images
# (the JAX package's takes 1.5 s here, 7 s in a 7x7x8 box)
BECKE_BOX = dict(a=(9.0, 9.0, 10.0), mesh=(11, 11, 13))
# above the pair rank of the two He2 cells, so the capped fit is full rank
GAMMA_NIP = 64


@pytest.fixture(scope="module")
def gamma_setup():
    """tests/test_isdf_gamma.py's cell: (cell, kpts, coords, AOs)."""
    cell = Cell(**GAMMA_KW).build()
    kpts = cell.get_kpts([1, 1, 2])
    coords = cell.gen_uniform_grids()
    return cell, kpts, coords, eval_ao_kpts(cell, coords, kpts,
                                            device="cpu")


@pytest.fixture(scope="module")
def he2():
    cell = Cell(**he2_kw()).build()
    kpts = cell.get_kpts([1, 1, 2])
    coords = cell.gen_uniform_grids()
    return cell, kpts, coords, eval_ao_kpts(cell, coords, kpts,
                                            device="cpu")


def _jax_df(df, cell_kw):
    """A JAX FFTISDF serving the port's built state (x_k, w_q, mask)."""
    jdf = JaxISDF(JaxCell(**cell_kw).build(), df.kpts, c0=df.c0, m0=df.m0,
                  verbose=0)
    jdf.x_k = jnp.asarray(df.x_k.numpy())
    jdf.wq = jnp.asarray(df.wq.numpy())
    jdf.mask = np.asarray(df.mask)
    return jdf


def test_pair_gram_and_eval_gamma_match_jax(gamma_setup):
    cell, kpts, coords, ao = gamma_setup
    zeta = gamma.pair_gram(ao).numpy()
    np.testing.assert_allclose(
        zeta, np.asarray(jax_gamma.pair_gram(jnp.asarray(ao.numpy()))),
        atol=1e-14 * np.abs(zeta).max())
    ao_g = eval_ao_gamma(cell, coords, device="cpu")
    assert ao_g.dtype == torch.float64 and ao_g.shape == ao.shape[1:]
    np.testing.assert_allclose(
        ao_g.numpy(), np.asarray(jax_eval_gamma(JaxCell(**GAMMA_KW).build(),
                                                coords)), atol=1e-13)
    np.testing.assert_allclose(gamma.pair_gram(ao_g).numpy(),
                               np.asarray(jax_gamma.pair_gram(
                                   jnp.asarray(ao_g.numpy()))), atol=1e-13)


def test_fit_gamma_full_rank_and_eri(gamma_setup):
    """Full-rank global fit: every k-pair density reconstructed to 1e-10,
    and the ERIs through the fitted functions' Coulomb metric equal the
    exact plane-wave ERIs to 1e-10 (tests/test_isdf_gamma.py); the
    metric of the JAX package's fit, computed by each package, agrees."""
    cell, kpts, coords, ao = gamma_setup
    xi, mask, rank = gamma.fit_gamma(ao, nip=GAMMA_NIP)
    assert rank == len(mask) < GAMMA_NIP
    nk = ao.shape[0]
    for k1 in range(nk):
        for k2 in range(nk):
            ref = ao[k1].conj()[:, :, None] * ao[k2][:, None, :]
            rho = gamma.reconstruct_pair(xi, mask, ao[k1], ao[k2])
            assert float((rho - ref).abs().max()) < 1e-10, (k1, k2)
    k3c = kpt_mod.get_kconserv3(cell, kpts)
    mj = torch.as_tensor(mask)
    for (k1, k2, k3) in [(0, 0, 0), (0, 1, 1), (1, 0, 0)]:
        k4 = k3c[k1, k2, k3]
        qv = kpts[k2] - kpts[k1]
        coul = gamma.coul_q_from_xi(cell, xi, coords, qv)
        x = [ao[k][mj] for k in (k1, k2, k3, k4)]
        eri = torch.einsum("IJ,Im,In,Jk,Jl->mnkl", coul, x[0].conj(), x[1],
                           x[2].conj(), x[3])
        ref = get_eri_from_ao(cell, [ao[k] for k in (k1, k2, k3, k4)], qv,
                              coords)
        assert float((eri - ref).abs().max()) < 1e-10, (k1, k2, k3)
    qv = kpts[1] - kpts[0]

    def jax_side():
        xi_j = jax_gamma.fit_gamma(jnp.asarray(ao.numpy()), nip=GAMMA_NIP)[0]
        return xi_j, jax_gamma.coul_q_from_xi(JaxCell(**GAMMA_KW).build(),
                                              xi_j, coords, qv)

    xi_j, c_j = recorded("gamma_thc/fit_gamma", jax_side)
    c_t = gamma.coul_q_from_xi(cell, torch.as_tensor(xi_j), coords,
                               qv).numpy()
    np.testing.assert_allclose(c_t, c_j, atol=1e-12 * np.abs(c_j).max())


def test_fit_gamma_compression_monotone(gamma_setup):
    _, _, _, ao = gamma_setup
    ref = ao[0].conj()[:, :, None] * ao[1][:, None, :]
    errs = []
    for nip in (4, 8, 16):
        xi, mask, _ = gamma.fit_gamma(ao, nip=nip)
        assert len(mask) <= nip
        errs.append(float((gamma.reconstruct_pair(xi, mask, ao[0], ao[1])
                           - ref).abs().max()))
    assert errs[-1] < errs[0] and errs[-1] < 1e-6


def test_pw_cderi_matches_jax_and_eri(he2):
    """The exact plane-wave factor pairs into the oracle ERIs (1e-10) and
    equals the JAX package's."""
    cell, kpts, coords, ao = he2
    cell_j = JaxCell(**he2_kw()).build()
    k3c = kpt_mod.get_kconserv3(cell, kpts)
    for (k1, k2, k3) in [(0, 0, 0), (0, 1, 0), (1, 0, 1)]:
        k4 = k3c[k1, k2, k3]
        q = kpts[k2] - kpts[k1]
        c12 = pw_cderi(cell, ao[k1], ao[k2], q, coords)
        c43 = pw_cderi(cell, ao[k4], ao[k3], q, coords)
        eri = torch.einsum("Qmn,Qlk->mnkl", c12, c43.conj())
        ref = get_eri_from_ao(cell, [ao[k] for k in (k1, k2, k3, k4)], q,
                              coords)
        assert float((eri - ref).abs().max()) < 1e-10, (k1, k2, k3)
        c12_j = recorded(f"gamma_thc/pw_cderi/{k1}{k2}{k3}",
                         lambda: jax_thc.pw_cderi(
                             cell_j, jnp.asarray(ao[k1].numpy()),
                             jnp.asarray(ao[k2].numpy()), q, coords))
        np.testing.assert_allclose(c12.numpy(), np.asarray(c12_j),
                                   atol=1e-13)


@pytest.mark.parametrize("mode", ["uniform", "row_only", "becke"])
def test_lsthc_error_report_matches_jax(mode):
    """LS-THC's cderi error report against the JAX package's: full rank
    on the uniform grid below 1e-7, the reference's k1 = 0 row exact on
    the fitted row and approximate (< 0.2) outside it, Becke grids below
    5e-5 (the JAX gates); each pair's error within the JAX package's, to
    the gate (the fits differ by roundoff-level pivots)."""
    kw = he2_kw(**BECKE_BOX) if mode == "becke" else he2_kw()
    cell = Cell(**kw).build()
    kpts = cell.get_kpts([1, 1, 2])
    grids = (becke.AtomCenteredGrids(cell, level=0).build()
             if mode == "becke" else None)
    thc = LSTHC(cell, kpts, verbose=0, grids=grids, device="cpu").build(
        row_only=mode == "row_only")
    assert thc.coul_q.shape[0] == len(kpts)
    report = {(k1, k2): (e1, e2) for k1, k2, e1, e2 in thc.error_report()}
    ref = {(int(r[0]), int(r[1])): r[2] for r in REFS["lsthc_he2"][mode]}
    assert report.keys() == ref.keys()
    gate = {"uniform": 1e-7, "becke": 5e-5}.get(mode)
    for key, (e1, e2) in report.items():
        if mode == "row_only":
            # exact on the fitted row; elsewhere the reference's error
            assert e1 < (1e-10 if key[0] == 0 else 0.2), key
            assert abs(e1 - ref[key]) < 1e-8 * ref[key] + 1e-10, key
        else:
            assert e1 < gate and ref[key] < gate, key
        assert e2 >= e1


def test_becke_grids_match_jax():
    """AtomCenteredGrids, radial_becke and angular_product equal the JAX
    package's, and the grids integrate normalised periodic Gaussians to
    the electron count (tests/test_becke.py)."""
    kw = he2_kw(**BECKE_BOX)
    cell = Cell(**kw).build()
    g = becke.AtomCenteredGrids(cell, level=0).build()
    mu = np.linspace(-1.0, 1.0, 41)
    fns = ((becke.radial_becke, (60, 1.0)), (becke.angular_product, (8,)))

    def jax_side():
        gj = jax_becke.AtomCenteredGrids(JaxCell(**kw).build(),
                                         level=0).build()
        out = [gj.coords, gj.weights, jax_becke._becke_s(mu)]
        for fn, args in fns:
            out += list(getattr(jax_becke, fn.__name__)(*args))
        return out

    ref = recorded("gamma_thc/becke", jax_side)
    np.testing.assert_array_equal(g.coords, ref[0])
    np.testing.assert_allclose(g.weights, ref[1],
                               atol=1e-13 * np.abs(ref[1]).max())
    got = [a for fn, args in fns for a in fn(*args)]
    assert len(got) == len(ref) - 3
    for a, b in zip(got, ref[3:]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(becke._becke_s(mu), ref[2], atol=1e-15)
    dens = np.zeros(len(g.coords))
    a = np.asarray(cell.a)
    for (_, xyz), al in zip(cell.atom, (0.8, 1.6)):
        for t in np.stack(np.meshgrid(*[np.arange(-2, 3)] * 3,
                                      indexing="ij"), -1).reshape(-1, 3):
            d2 = np.sum((g.coords - (np.asarray(xyz) + t @ a)) ** 2, axis=1)
            dens += (al / np.pi) ** 1.5 * np.exp(-al * d2)
    np.testing.assert_allclose(np.sum(g.weights * dens), 2.0, atol=5e-3)


@pytest.fixture(scope="module")
def he2_full():
    """Full-rank He2 build (tests/test_thc_ao2mo.py) and its JAX twin."""
    cell = Cell(**he2_kw()).build()
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=50.0, m0=tuple(cell.mesh), verbose=0,
                 select_tol=1e-20, rcond=1e-13, device="cpu").build()
    return cell, kpts, df, _jax_df(df, he2_kw())


def test_mo_eri_matches_jax_and_oracle(he2, he2_full):
    """MO ERIs from the ISDF state against the oracle MO ERIs (1e-9) and
    the JAX package's on the same state."""
    _, _, coords, ao = he2
    cell, kpts, df, jdf = he2_full
    rng = np.random.default_rng(0)
    nao = ao.shape[2]
    cs = [rng.standard_normal((nao, 2)) + 1j * rng.standard_normal((nao, 2))
          for _ in range(4)]
    kidx = (0, 1, 1, 0)
    eri_mo = ao2mo.mo_eri(df, cs, kidx).numpy()
    eri_ao = get_eri_from_ao(cell, [ao[k] for k in kidx],
                             kpts[1] - kpts[0], coords).numpy()
    ref = np.einsum("mnkl,mi,nj,kx,ly->ijxy", eri_ao, cs[0].conj(), cs[1],
                    cs[2].conj(), cs[3])
    assert np.abs(eri_mo - ref).max() < 1e-9
    np.testing.assert_allclose(eri_mo,
                               np.asarray(jax_ao2mo.mo_eri(jdf, cs, kidx)),
                               atol=1e-12)
    with pytest.raises(ValueError):
        ao2mo.mo_eri(df, cs, (0, 1, 1, 1))


def test_trans_2e_matches_jax(he2_full):
    """The embedding-space ERI equals the JAX package's; it is real and
    8-fold symmetric (tests/test_thc_ao2mo.py), and at nk = 1 it is the
    plain ERI."""
    cell, kpts, df, jdf = he2_full
    eri = ao2mo.trans_2e(df).numpy()
    np.testing.assert_allclose(eri, np.asarray(jax_ao2mo.trans_2e(jdf)),
                               atol=1e-12)
    assert np.abs(eri.imag).max() < 1e-8
    np.testing.assert_allclose(eri, eri.transpose(1, 0, 3, 2).conj(),
                               atol=1e-8)
    np.testing.assert_allclose(eri, eri.transpose(2, 3, 0, 1), atol=1e-8)
    df1 = FFTISDF.from_numpy(cell, np.zeros((1, 3)), df.x_k[:1].numpy(),
                             df.wq[:1].numpy(), df.mask, df.m0,
                             device="cpu")
    np.testing.assert_allclose(ao2mo.trans_2e(df1).numpy(),
                               df1.get_eri((0, 0, 0, 0)).numpy(),
                               atol=1e-10)


def test_whiten_basis_matches_jax(he2_full):
    """whiten_basis per sector: v^H x4 v is diagonal to roundoff
    (tests/test_whiten_multisector.py), the scale equals the JAX
    package's and the rotation reproduces its quadratic form."""
    cell, kpts, df, _ = he2_full
    phase = torch.as_tensor(df.phase, dtype=torch.complex128)
    x4 = _stripe_quartic(df.x_k, phase)
    x_rot, scale = whiten_basis(df.x_k, x4)

    def jax_side():
        x_rot_j, scale_j = jax_whiten(jnp.asarray(df.x_k.numpy()),
                                      jnp.asarray(x4.numpy()))
        return (scale_j,
                jnp.conj(jnp.swapaxes(x_rot_j, -1, -2)) @ x_rot_j)

    scale_j, gram_j = recorded("gamma_thc/whiten", jax_side)
    # the kept spectrum: 1/scale is the eigenvalue, to eigh roundoff
    inv = lambda sc: np.where(sc > 0, 1.0 / np.where(sc > 0, sc, 1.0), 0.0)
    w_t, w_j = inv(scale.numpy()), inv(np.asarray(scale_j))
    np.testing.assert_array_equal(w_t > 0, w_j > 0)
    np.testing.assert_allclose(w_t, w_j, atol=1e-12 * np.abs(w_j).max())
    # rows of x_rot carry each eigenvector's free phase: compare grams
    np.testing.assert_allclose((x_rot.mH @ x_rot).numpy(), gram_j,
                               atol=1e-10 * float(x_rot.abs().max()) ** 2)
    w, v = torch.linalg.eigh(x4)
    for q in range(x4.shape[0]):
        a_rot = v[q].mH @ x4[q] @ v[q]
        off = a_rot - torch.diag(torch.diagonal(a_rot))
        assert float(off.abs().max()) < 1e-12 * max(
            1.0, float(a_rot.abs().max()))
    np.testing.assert_allclose(x_rot.numpy(),
                               (v.mH @ df.x_k).numpy(), atol=1e-14)
