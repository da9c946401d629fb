"""The port's float32 regime against the JAX package's (CPU).

The port's counterpart of tests/test_f32_regime.py on the same diamond
configuration and density, with the same gates (5e-4 at c0 20, 1.5e-5 at
c0 40, the 2.5x ratio), held against the port's exact oracle in float32;
the float32 build against the JAX package's float32 build given its mask;
selection in float64 inside a float32 build, ``select_keep``,
``auto_selection_mesh`` and the densify loop of ``m0='auto'`` against the
JAX package's; the round trip of a float32 state in both directions; and
KUHF / DeviceKUHF in float32 against the JAX package's float32 KUHF
(recorded in tests/data/jax_port_refs.json).
JAX runs on the CPU (its float32 selection takes its numpy route there,
its float64 one the einsum gram).
"""
import json
import warnings
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.isdf import FFTISDF as JaxISDF
from fftisdf_tpu.isdf import kpoint as jax_kp
from fftisdf_tpu.lattice import structure as jax_structure
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.utils.device import to_device
from jax_records import recorded
from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import FFTISDF, kpoint as t_kp
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.linalg.pivoted_cholesky import (
    pivoted_cholesky_pairgram)
from fftisdf_tpu_torch.pw import jk as pw_jk
from fftisdf_tpu_torch.scf import KUHF, DeviceKUHF

F32 = torch.float32
REFS = json.loads((Path(__file__).parent / "data"
                   / "jax_port_refs.json").read_text())


@pytest.fixture(scope="module")
def diamond():
    """(JAX cell, port cell, kpts, the density of test_f32_regime.py)."""
    kw = dict(basis="gth-szv", pseudo="gth-pade", ke_cutoff=50.0)
    cell_j = jax_structure.to_cell(*jax_structure.bulk_diamond(), **kw)
    cell = structure.to_cell(*structure.bulk_diamond(), **kw)
    kpts = cell.get_kpts([1, 1, 2])
    nk, nao = 2, cell.nao_nr()
    rng = np.random.default_rng(0)
    dm = rng.standard_normal((nk, nao, nao)) * 0.1 + np.eye(nao)[None]
    dm = (dm + dm.transpose(0, 2, 1)).astype(np.complex128)
    return cell_j, cell, kpts, dm


def he2_cells(asymmetric=True):
    atoms = ([("He", (2.1, 2.6, 2.0)), ("He", (2.7, 2.3, 4.4))]
             if asymmetric else
             [("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))])
    kw = dict(a=np.diag([5.0, 5.0, 7.0]), atom=atoms, basis="sto-3g",
              pseudo=None, mesh=np.array([15, 15, 21]), unit="bohr",
              precision=1e-12)
    return JaxCell(**kw).build(), Cell(**kw).build()


def _maxerr(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _quiet():
    ctx = warnings.catch_warnings()
    ctx.__enter__()
    warnings.simplefilter("ignore")
    return ctx


def test_f32_ridge_jk_accuracy(diamond):
    """tests/test_f32_regime.py's gates on the port: the default ridge fit
    keeps compressed J/K at the compression floor in float32."""
    _, cell, kpts, dm = diamond
    ao = make_evaluator(cell, kpts=kpts, dtype=F32, device="cpu")(
        cell.gen_uniform_grids())
    assert ao.dtype == torch.complex64
    vj_e, vk_e = pw_jk.get_jk_kpts(cell, dm, ao, kpts)
    assert vk_e.dtype == torch.complex64
    # the float32 oracle itself: 1e-5 from the float64 one (measured 2e-7
    # / 9e-7: float32 FFTs of a 20^3 mesh)
    ao64 = make_evaluator(cell, kpts=kpts, device="cpu")(
        cell.gen_uniform_grids())
    vj_64, vk_64 = pw_jk.get_jk_kpts(cell, dm, ao64, kpts)
    assert _maxerr(vj_e, vj_64) < 1e-5 and _maxerr(vk_e, vk_64) < 1e-5

    ctx = _quiet()
    df = FFTISDF(cell, kpts, c0=20.0, m0=(7, 7, 7), verbose=0, dtype=F32,
                 device="cpu").build()
    assert (df.rcond, df.refine) == (1e-5, 2)
    assert df.x_k.dtype == df.wq.dtype == torch.complex64
    assert df.get_ws().dtype == torch.float32
    vj, vk = df.get_jk(dm)
    assert vj.dtype == torch.complex64
    ej, ek = _maxerr(vj, vj_e), _maxerr(vk, vk_e)
    assert ej < 5e-4 and ek < 5e-4, (ej, ek)
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0, dtype=F32,
                 device="cpu").build()
    ctx.__exit__(None, None, None)
    vj, vk = df.get_jk(dm)
    ej40, ek40 = _maxerr(vj, vj_e), _maxerr(vk, vk_e)
    assert ej40 < 1.5e-5 and ek40 < 1.5e-5, (ej40, ek40)
    assert ej40 < 2.5 * ej and ek40 < 2.5 * ek, (ej, ej40, ek, ek40)


def test_f32_build_matches_jax_given_mask(diamond):
    """Past selection the two float32 pipelines agree: the port's build on
    the JAX package's interpolation points serves the JAX float32 build's
    J/K to 5e-5 (each is ~5e-6 from the exact J/K; two float32 roundoff
    histories of a fit with cond ~1e5).  The build-dtype selection route
    (through K1's plain version here) holds the same gate against it.  The
    JAX build's mask and J/K on this density are recorded
    (tests/data/jax_port_refs.json ``jax_sides``)."""
    cell_j, cell, kpts, dm = diamond
    rec = REFS["jax_sides"]["f32_build"]
    unpack = lambda d: (np.asarray(d["re"]) + 1j * np.asarray(d["im"])
                        ).reshape(d["shape"])
    vj_j, vk_j = unpack(rec["vj"]), unpack(rec["vk"])
    ctx = _quiet()
    df = FFTISDF(cell, kpts, c0=20.0, m0=(7, 7, 7), verbose=0, dtype=F32,
                 device="cpu").build(mask=np.asarray(rec["mask"]))
    vj, vk = df.get_jk(dm)
    assert df.nip == rec["nip"]
    assert _maxerr(vj, vj_j) < 5e-5 and _maxerr(vk, vk_j) < 5e-5
    df_k1 = FFTISDF(cell, kpts, c0=20.0, m0=(7, 7, 7), verbose=0, dtype=F32,
                    select_host_f64=False, device="cpu").build()
    ctx.__exit__(None, None, None)
    # float32 selection keeps all max_rank pivots (no rank detection)
    assert df_k1.nip == int(20.0 * cell.nao_nr())
    vj1, vk1 = df_k1.get_jk(dm)
    assert _maxerr(vj1, vj_j) < 5e-4 and _maxerr(vk1, vk_j) < 5e-4


def test_selection_f64_inside_f32_build_matches_jax():
    """A float32 build selects in float64 by default.  On a He2 cell
    without mirror symmetry (no ties) the mask, nip and rank are the JAX
    package's float64 host selection's, x_k is the float64 AO cast to
    complex64, and the Schur diagonal at every pivot agrees with the JAX
    package's numpy factorisation to 1e-10 of the first; with
    ``use_trs=False`` (no halving) the same points come out.  The points
    are compared while the Schur diagonal stands 100x above the port's tie
    window, ng0 eps hist[0]: among candidates closer than the window the
    port takes the lowest index, the JAX package the plain argmax (here
    the last two of 11 pivots, at 1e-12 of the first)."""
    from fftisdf_tpu.basis.eval import eval_ao_numpy
    from fftisdf_tpu.linalg.pivoted_cholesky import (
        pivoted_cholesky_pairgram_np)

    cell_j, cell = he2_cells()
    kpts = cell.get_kpts([1, 1, 3])
    m0, c0 = (9, 9, 13), 10.0
    ctx = _quiet()
    x_j, m_j, r_j, _ = jax_kp.select_interpolation_points(
        cell_j, kpts, m0, c0, dtype=jnp.float32)
    x_t, m_t, r_t, m0_t = t_kp.select_interpolation_points(
        cell, kpts, m0, c0, dtype=F32, device="cpu")
    x_n, m_n, r_n, _ = t_kp.select_interpolation_points(
        cell, kpts, m0, c0, dtype=F32, use_trs=False, device="cpu")
    ctx.__exit__(None, None, None)
    assert m0_t == m0 and r_t == int(r_j) == r_n
    assert len(m_t) == len(m_j) == len(m_n)
    assert x_t.dtype == torch.complex64 and x_t.shape == (3, len(m_t), 2)
    # the pivot residuals of the two factorisations, on the canonical half
    # of the k axis with sqrt(2) on the conjugate pair
    coords0 = cell.gen_uniform_grids(m0)
    ksel, wk = [0, 1], np.sqrt([1.0, 2.0])
    x0_j = eval_ao_numpy(cell_j, coords0, kpts[ksel])
    flat = np.transpose(x0_j, (1, 0, 2)).reshape(len(coords0), -1) \
        * np.repeat(wk, 2)[None, :]
    probe = int(20 * 1.15) + 8
    _, _, hist_j = pivoted_cholesky_pairgram_np(flat, 3, probe)
    x0_t = make_evaluator(cell, kpts=kpts[ksel], device="cpu")(coords0)
    flat_t = x0_t.permute(1, 0, 2).reshape(len(coords0), -1) \
        * torch.from_numpy(np.repeat(wk, 2))
    _, _, hist_t = pivoted_cholesky_pairgram(flat_t, 3, probe)
    np.testing.assert_allclose(hist_t, hist_j, rtol=0,
                               atol=1e-10 * hist_j[0])
    window = 100 * len(coords0) * np.finfo(np.float64).eps * hist_t[0]
    sure = int(np.sum(hist_t[:len(m_t)] > window))
    assert sure >= len(m_t) - 2
    np.testing.assert_array_equal(m_t[:sure], np.asarray(m_j)[:sure])
    np.testing.assert_array_equal(m_n[:sure], m_t[:sure])
    np.testing.assert_allclose(x_t.numpy()[:, :sure],
                               np.asarray(x_j)[:, :sure], atol=1e-6, rtol=0)
    np.testing.assert_allclose(x_n.numpy()[:, :sure], x_t.numpy()[:, :sure],
                               atol=1e-6, rtol=0)


def test_select_keep_and_saturation_before_trim():
    """``select_keep`` trims the pivots below keep_tol * hist[0] as the JAX
    package does (same nip, same leading points).  Saturation is read
    before the trim: a pool whose rank the request exhausts stays
    saturated after the trim has cut nip below 90% of the rank, where the
    JAX package reads it after and reports an unsaturated pool."""
    cell_j, cell = he2_cells()
    kpts = cell.get_kpts([1, 1, 2])
    m0, c0, keep = (5, 5, 7), 10.0, 1e-3
    ctx = _quiet()
    out_j = jax_kp._select_once(cell_j, kpts, m0, c0, dtype=jnp.float32,
                                keep_tol=keep)
    out_0 = t_kp._select_once(cell, kpts, m0, c0, dtype=F32, device="cpu")
    out_t = t_kp._select_once(cell, kpts, m0, c0, dtype=F32, keep_tol=keep,
                              device="cpu")
    ctx.__exit__(None, None, None)
    x_t, m_t, r_t, sat_t, ng0, nip_t = out_t
    assert nip_t == out_j[5] and r_t == int(out_j[2])
    np.testing.assert_array_equal(m_t, np.asarray(out_j[1]))
    assert nip_t < out_0[5] and x_t.shape[1] == nip_t
    # untrimmed: nip reaches the rank of this small pool
    assert out_0[3] and out_0[5] >= 0.9 * r_t
    # trimmed below 90% of the rank: the port still says saturated
    assert nip_t < 0.9 * r_t
    assert sat_t and not bool(out_j[3])


def test_auto_selection_mesh_matches_jax(diamond):
    cell_j, cell, _, _ = diamond
    he_j, he = he2_cells()
    for cj, ct in ((cell_j, cell), (he_j, he)):
        for kw in (dict(nip_target=160), dict(nip_target=2480),
                   dict(nip_target=2480, pool_factor=4.0),
                   dict(nip_target=300, floor=None),
                   dict(nip_target=300, floor=(5, 5, 9)),
                   dict(nip_target=1, k0=12.0), dict(nip_target=1, k0=40.0)):
            kw = dict(kw)
            target = kw.pop("nip_target")
            assert t_kp.auto_selection_mesh(ct, target, **kw) \
                == jax_kp.auto_selection_mesh(cj, target, **kw), kw
    # the constructor resolves 'auto' the same way, k0 included
    kpts = he.get_kpts([1, 1, 2])
    for kw in (dict(), dict(k0=20.0), dict(m0_pool=6.0, m0_floor=(3, 3, 3))):
        assert FFTISDF(he, kpts, c0=10.0, device="cpu", **kw).m0 \
            == JaxISDF(he_j, kpts, c0=10.0, **kw).m0


def test_m0_auto_densifies_like_jax(monkeypatch):
    """m0='auto' from a floor so low that the pool saturates: the densify
    steps, the final mesh, nip and rank are the JAX package's (float64,
    where both select through the dense gram), and a saturated explicit
    mesh warns once per (m0, nip).  In a float32 build the loop does not
    densify past the float64 selection cap."""
    _, cell = he2_cells()
    kpts = cell.get_kpts([1, 1, 2])
    # the JAX package's build of this configuration, recorded by
    # tools/jax_port_refs.py
    ref = REFS["test_m0_auto_densifies_like_jax"]
    kw = dict(c0=10.0, m0="auto", m0_pool=1.0, m0_floor=(2, 2, 2), verbose=0)
    ctx = _quiet()
    df = FFTISDF(cell, kpts, device="cpu", **kw).build()
    ctx.__exit__(None, None, None)
    m0_start = t_kp.auto_selection_mesh(cell, 20.0, pool_factor=1.0,
                                        floor=(2, 2, 2))
    assert df.m0 == tuple(ref["m0"]) and np.prod(df.m0) > np.prod(m0_start)
    assert df.nip == ref["nip"]
    assert df.mask.max() < np.prod(df.m0)

    t_kp._saturation_warned.clear()
    with pytest.warns(t_kp.PoolSaturationWarning):
        t_kp.select_interpolation_points(cell, kpts, m0_start, 10.0,
                                         device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the second time: silent
        t_kp.select_interpolation_points(cell, kpts, m0_start, 10.0,
                                         device="cpu")

    # float32: a cap below the densified pool stops the loop at m0_start
    monkeypatch.setattr(t_kp, "SELECT_F64_MAX_NG0", int(np.prod(m0_start)))
    ctx = _quiet()
    _, mask, _, m0_kept = t_kp.select_interpolation_points(
        cell, kpts, m0_start, 10.0, dtype=F32, auto_densify=True,
        device="cpu")
    ctx.__exit__(None, None, None)
    assert m0_kept == m0_start


def test_f32_memory_plan_in_build_itemsize(diamond):
    """The same byte budget holds twice the sector planes in float32: the
    plan is computed in the build's itemsize."""
    _, cell, kpts, _ = diamond
    ngrid, nip, nao = int(np.prod(cell.mesh)), 136, cell.nao_nr()
    plans = {}
    for dt in (torch.float64, F32):
        df = FFTISDF(cell, cell.get_kpts([2, 2, 2]), m0=(7, 7, 7), dtype=dt,
                     max_memory_gb=0.08, device="cpu")
        plans[dt] = df._memory_plan(5, 5, nip, nao, ngrid)
    assert plans[F32][0] > plans[torch.float64][0]
    assert plans[F32][1] >= plans[torch.float64][1]
    df = FFTISDF(cell, kpts, m0=(7, 7, 7), blksize=100, device="cpu")
    assert df._memory_plan(2, 2, nip, nao, ngrid)[1] == 100


def test_f32_state_round_trip(tmp_path, diamond):
    """A float32 state written by the JAX package (widened to complex128
    on disk) loads into the port, as stored or in complex64 on request,
    and serves the same J/K (2e-6 relative: float32 roundoff of the
    serve); the port's float32 state, complex64 on disk, loads into the
    JAX package."""
    cell_j, cell, kpts, dm = diamond
    path = tmp_path / "jax_f32.npz"

    def jax_side():
        ctx = _quiet()
        df_j = JaxISDF(cell_j, kpts, c0=10.0, m0=(7, 7, 7), verbose=0,
                       dtype=jnp.float32).build()
        ctx.__exit__(None, None, None)
        df_j.save(path)
        return (np.frombuffer(path.read_bytes(), dtype=np.uint8),
                df_j.mask) + tuple(df_j.get_jk(
                    to_device(dm, dtype=jnp.complex64)))

    # the JAX package's file, byte for byte, and its J/K
    raw, mask_j, vj_j, vk_j = recorded("f32_regime/state_file", jax_side)
    path.write_bytes(raw.tobytes())
    ctx = _quiet()
    df_t = FFTISDF(cell, kpts, c0=10.0, m0=(7, 7, 7), verbose=0, dtype=F32,
                   device="cpu").build()
    ctx.__exit__(None, None, None)
    for dt, cdt in ((None, torch.complex128), (F32, torch.complex64)):
        df_l = FFTISDF.load(path, cell, kpts, dtype=dt, device="cpu")
        assert df_l.wq.dtype == df_l.x_k.dtype == cdt
        np.testing.assert_array_equal(df_l.mask, mask_j)
        vj_l, vk_l = df_l.get_jk(dm)
        for a, b in ((vj_l, vj_j), (vk_l, vk_j)):
            assert _maxerr(a, b) < 2e-6 * float(np.abs(np.asarray(b)).max())
    path2 = tmp_path / "torch_f32.npz"
    df_t.save(path2)
    with np.load(path2) as data:
        assert data["wq"].dtype == np.complex64
    df_b = JaxISDF.load(path2, cell_j, kpts)
    vj_b, vk_b = df_b.get_jk(to_device(dm, dtype=jnp.complex64))
    vj_t, vk_t = df_t.get_jk(dm)
    for a, b in ((vj_t, vj_b), (vk_t, vk_b)):
        assert _maxerr(a, b) < 2e-6 * float(np.abs(np.asarray(b)).max())


def test_kuhf_f32_matches_jax(diamond):
    """KUHF and DeviceKUHF in float32 (float32 integrals, overlap cutoff
    2e-6, a float32 build on the JAX package's points) against the JAX
    package's float32 KUHF: 2e-5 Ha (the float32 serve's noise on a -11 Ha
    energy; the final energy is recomputed in float64 from float32 J/K),
    and the two port loops to the same bound.  The JAX package's float32
    build (its mask) and KUHF are read from tests/data/jax_port_refs.json
    (``tools/jax_port_refs.py``)."""
    _, cell, kpts, _ = diamond
    ref = REFS["test_kuhf_f32_matches_jax"]
    ctx = _quiet()
    df = FFTISDF(cell, kpts, c0=20.0, m0=(9, 9, 9), verbose=0, dtype=F32,
                 device="cpu").build(mask=np.asarray(ref["mask"]))
    ctx.__exit__(None, None, None)
    kw = dict(verbose=0, conv_tol=1e-7, smearing=5e-3, max_cycle=60)
    mf = KUHF(cell, kpts, df, dtype=F32, device="cpu", **kw)
    assert mf.ovlp_cutoff == ref["ovlp_cutoff"] == 2e-6
    assert mf.s1e.dtype == np.complex128
    e_h = mf.kernel()
    mfd = DeviceKUHF(cell, kpts, df, dtype=F32, device="cpu", **kw)
    e_d = mfd.kernel()
    assert mf.converged and mfd.converged and ref["converged"]
    assert abs(e_h - ref["e_tot"]) < 2e-5
    assert abs(e_d - ref["e_tot"]) < 2e-5
    assert abs(e_d - e_h) < 2e-5
    # a float64 loop over the float32 provider serves through a cast
    e_m = DeviceKUHF(cell, kpts, df, device="cpu", **kw).kernel()
    assert abs(e_m - e_h) < 2e-5
