"""The port's range-separated (omega) and truncated (0d, 2d) Coulomb
kernels through the ISDF build and the exact oracle, against the JAX
package (CPU, f64).

Counterparts of tests/test_omega_jk.py and of the ISDF tests of
tests/test_coulomb_trunc.py (without the sharded one), with their
tolerances: full-rank J/K against the exact plane-wave J/K to 1e-9,
compressed J/K to 1e-4, the limits of the screened metrics, the guards.
The exact oracle of the port is held against the JAX package's with the
same kernel to 1e-10 relative, and a truncated state goes through the
``.npz`` format in both directions.
"""
import json
import warnings
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fftisdf_tpu.isdf import FFTISDF as JaxISDF
from fftisdf_tpu.lattice.cell import Cell as JaxCell
from fftisdf_tpu.lattice import kpoints as kpt_mod
from fftisdf_tpu.pw import jk as jax_pw_jk
from fftisdf_tpu.scf.hf import PWDF as JaxPWDF
from jax_records import recorded
from fftisdf_tpu_torch.basis.eval import eval_ao_kpts
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice.cell import Cell
from fftisdf_tpu_torch.pw import jk as pw_jk
from fftisdf_tpu_torch.scf import KRHF, PWDF

OMEGA = 0.6
HE2 = dict(a=np.diag([5.0, 5.0, 7.0]),
           atom=[("He", (2.5, 2.5, 2.0)), ("He", (2.5, 2.5, 4.5))],
           basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 21]),
           unit="bohr", precision=1e-12)
HE2_BOX = dict(a=np.diag([7.0, 7.0, 8.0]),
               atom=[("He", (3.5, 3.5, 3.2)), ("He", (3.5, 3.5, 4.8))],
               basis="sto-3g", pseudo=None, mesh=np.array([15, 15, 17]),
               unit="bohr", precision=1e-12)


def trs_dm(cell, kpts, nao, seed=0):
    """Random hermitian density with dm[-k] = conj(dm[k])."""
    rng = np.random.default_rng(seed)
    nk = len(kpts)
    s = cell.get_scaled_kpts(kpts)
    dm = rng.standard_normal((nk, nao, nao)) \
        + 1j * rng.standard_normal((nk, nao, nao))
    dm = dm + dm.conj().transpose(0, 2, 1)
    for k in range(nk):
        km = kpt_mod.member(-s[k], s)
        if km < k:
            continue
        avg = (dm[k] + dm[km].conj()) / 2
        dm[k], dm[km] = avg, avg.conj()
    return dm


def _maxerr(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _rel(a, b):
    return _maxerr(a, b) / float(np.abs(np.asarray(b)).max())


def _build(cell, kpts, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return FFTISDF(cell, kpts, verbose=0, device="cpu", **kw).build()


FULL_RANK = dict(c0=50.0, select_tol=1e-20, rcond=1e-13)


@pytest.fixture(scope="module")
def he2():
    cell_j, cell = JaxCell(**HE2).build(), Cell(**HE2).build()
    kpts = cell.get_kpts([1, 1, 2])
    ao = eval_ao_kpts(cell, cell.gen_uniform_grids(), kpts, device="cpu")
    return cell_j, cell, kpts, ao, trs_dm(cell, kpts, 2)


@pytest.fixture(scope="module")
def he2_compressed(he2):
    _, cell, kpts, _, _ = he2
    return _build(cell, kpts, c0=10.0, m0=(9, 9, 13))


@pytest.mark.parametrize("kw", [dict(omega=OMEGA), dict(omega=-OMEGA),
                                dict(trunc=("0d", 2.5)),
                                dict(trunc=("2d", 3.5))],
                         ids=["erf", "erfc", "0d", "2d"])
def test_exact_oracle_kernels_match_jax(he2, kw):
    """pw.get_jk_kpts with a screened or truncated kernel against the JAX
    package's on the same AO values and density: 1e-10 relative."""
    cell_j, cell, kpts, ao, dm = he2
    key = "omega_trunc/exact/" + "/".join(f"{k}={v}" for k, v in kw.items())
    vj_j, vk_j = recorded(key, lambda: jax_pw_jk.get_jk_kpts(
        cell_j, jnp.asarray(dm), jnp.asarray(ao.numpy()), kpts, **kw))
    vj, vk = pw_jk.get_jk_kpts(cell, dm, ao, kpts, **kw)
    assert _rel(vj, vj_j) < 1e-10 and _rel(vk, vk_j) < 1e-10
    # the provider class passes the kernel through, set axis included
    pw = PWDF(cell, kpts, trunc=kw.get("trunc"), device="cpu")
    dms = np.stack([dm, dm.conj()])
    vj2, vk2 = pw.get_jk(dms, omega=kw.get("omega"))
    vj2_j, vk2_j = recorded(key + "/pwdf", lambda: JaxPWDF(
        cell_j, kpts, trunc=kw.get("trunc")).get_jk(
            dms, omega=kw.get("omega")))
    assert _rel(vj2, vj2_j) < 1e-10 and _rel(vk2, vk2_j) < 1e-10


def test_full_rank_screened_jk_exact(he2):
    """Exactness regime: screened ISDF J/K equal the screened plane-wave
    J/K for both erf (omega > 0) and erfc (omega < 0) kernels, 1e-9; one
    build serves both from its metric cache."""
    _, cell, kpts, ao, dm = he2
    df = _build(cell, kpts, m0=tuple(cell.mesh), **FULL_RANK)
    for omega in (OMEGA, -OMEGA):
        vj_ref, vk_ref = pw_jk.get_jk_kpts(cell, dm, ao, kpts, omega=omega)
        vj, vk = df.get_jk(dm, omega=omega)
        assert _maxerr(vj, vj_ref) < 1e-9, omega
        assert _maxerr(vk, vk_ref) < 1e-9, omega
    assert set(df._wq_omega) == {OMEGA, -OMEGA}
    # erf + erfc = bare on w_q, except the finite q+G = 0 sample of erfc
    wq_sum = df.get_wq_omega(OMEGA) + df.get_wq_omega(-OMEGA)
    assert float((wq_sum[1] - df.wq[1]).abs().max()) \
        < 1e-10 * float(df.wq[1].abs().max())


def test_compressed_screened_jk(he2, he2_compressed):
    """Compression regime: screened J/K at the usual ISDF gate against the
    exact screened J/K, against the JAX package's screened serve given its
    interpolation points (1e-8 relative; its mask and J/K on this density
    recorded in tests/data/jax_port_refs.json ``jax_sides``), and SR + LR
    - full a rank-1 metric in the q = 0 sector only."""
    cell_j, cell, kpts, ao, dm = he2
    df = he2_compressed
    rec = json.loads((Path(__file__).parent / "data"
                      / "jax_port_refs.json").read_text())["jax_sides"][
                          "omega_he2"]
    unpack = lambda d: (np.asarray(d["re"]) + 1j * np.asarray(d["im"])
                        ).reshape(d["shape"])
    assert OMEGA == 0.6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        df_m = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 13), verbose=0,
                       device="cpu").build(mask=np.asarray(rec["mask"]))
    for omega in (OMEGA, -OMEGA):
        vj_ref, vk_ref = pw_jk.get_jk_kpts(cell, dm, ao, kpts, omega=omega)
        vj, vk = df.get_jk(dm, omega=omega)
        scale = float(vk_ref.abs().max())
        assert _maxerr(vj, vj_ref) < 1e-4, omega
        assert _maxerr(vk, vk_ref) < 1e-4 * max(scale, 1.0), omega
        vj_j, vk_j = (unpack(rec[str(omega)][x]) for x in ("vj", "vk"))
        vj_m, vk_m = df_m.get_jk(dm, omega=omega)
        assert _rel(vj_m, vj_j) < 1e-8 and _rel(vk_m, vk_j) < 1e-8, omega
    wq_g0 = (df.get_wq_omega(-OMEGA) + df.get_wq_omega(OMEGA)
             - df.wq).numpy()
    for q in range(len(kpts)):
        sq = np.linalg.svd(wq_g0[q], compute_uv=False)
        if q == 0:
            assert sq[0] > 1e-10 and sq[1] < 1e-8 * sq[0], sq[:3]
        else:
            assert sq[0] < 1e-10, (q, sq[0])
    _, vk_full = df.get_jk(dm, with_j=False)
    _, vk_sr = df.get_jk(dm, with_j=False, omega=-OMEGA)
    _, vk_lr = df.get_jk(dm, with_j=False, omega=OMEGA)
    assert bool(torch.isfinite(vk_sr + vk_lr - vk_full).all())


def test_omega_limits(he2, he2_compressed):
    """|omega| -> inf: LR -> full quadratically, and the SR metric scales
    as 1/omega^2."""
    df = he2_compressed
    big = 50.0
    scale = float(df.wq.abs().max())
    e1 = float((df.get_wq_omega(big) - df.wq).abs().max())
    e2 = float((df.get_wq_omega(2.0 * big) - df.wq).abs().max())
    assert e1 < 1e-3 * scale, (e1, scale)
    assert 3.2 < e1 / e2 < 4.8, (e1, e2)
    s1 = float(df.get_wq_omega(-big).abs().max())
    s2 = float(df.get_wq_omega(-2.0 * big).abs().max())
    assert 3.2 < s1 / s2 < 4.8, (s1, s2)


def test_omega_guards(he2, he2_compressed):
    _, cell, kpts, _, dm = he2
    df = he2_compressed
    with pytest.raises(NotImplementedError):
        df.get_jk(dm, omega=0.5, exxdiv="ewald")
    with pytest.raises(NotImplementedError):
        df.get_jk(dm, omega=0.5, kpts_band=kpts[:1])
    vj0, _ = df.get_jk(dm, with_k=False)
    vj1, _ = df.get_jk(dm, with_k=False, omega=0.0)
    assert float((vj0 - vj1).abs().max()) == 0.0
    with pytest.raises(RuntimeError):
        FFTISDF(cell, kpts, m0=(9, 9, 13), device="cpu").get_wq_omega(0.5)


# ------------------------------------------------------------- truncation
@pytest.fixture(scope="module")
def he2_box():
    return JaxCell(**HE2_BOX).build(), Cell(**HE2_BOX).build()


@pytest.fixture(scope="module")
def box_0d(he2_box):
    """The port's compressed 0d-truncated build of the box at the gamma
    point (c0 10, m0 9x9x11)."""
    cell = he2_box[1]
    kpts = cell.get_kpts([1, 1, 1])
    return kpts, _build(cell, kpts, c0=10.0, m0=(9, 9, 11), trunc="0d")


@pytest.mark.parametrize("kind,kmesh,rc", [("0d", [1, 1, 1], 3.5),
                                           ("2d", [2, 1, 1], 4.0)])
def test_isdf_trunc_jk_exact(he2_box, kind, kmesh, rc):
    """Full-rank FFTISDF(trunc=...) reproduces the truncated exact
    plane-wave J/K, the port's and the JAX package's, to 1e-9.  The 2D
    kernel's q+G = 0 sample is negative: the rank-1 sign correction of the
    split metric is on the path."""
    cell_j, cell = he2_box
    kpts = cell.get_kpts(kmesh)
    ao = eval_ao_kpts(cell, cell.gen_uniform_grids(), kpts, device="cpu")
    df = _build(cell, kpts, m0=tuple(cell.mesh), trunc=kind, **FULL_RANK)
    assert df.trunc[0] == kind and abs(df.trunc[1] - rc) < 1e-10
    dm = trs_dm(cell, kpts, 2)
    vj_ref, vk_ref = pw_jk.get_jk_kpts(cell, dm, ao, kpts, trunc=df.trunc)
    vj_j, vk_j = recorded(f"omega_trunc/isdf_exact/{kind}",
                          lambda: jax_pw_jk.get_jk_kpts(
                              cell_j, jnp.asarray(dm),
                              jnp.asarray(ao.numpy()), kpts,
                              trunc=df.trunc))
    vj, vk = df.get_jk(dm)
    for ref_j, ref_k in ((vj_ref, vk_ref), (vj_j, vk_j)):
        assert _maxerr(vj, ref_j) < 1e-9 and _maxerr(vk, ref_k) < 1e-9
    vj_b, _ = pw_jk.get_jk_kpts(cell, dm, ao, kpts)
    assert _maxerr(vj, vj_b) > 1e-4      # not the bare kernel's
    if kind == "2d":
        from fftisdf_tpu_torch.linalg.coulomb import get_coulG

        assert float(get_coulG(cell, mesh=cell.mesh, trunc=df.trunc,
                               device="cpu").min()) < -1e-8


def test_compressed_trunc_2d_matches_jax(he2_box):
    """A compressed 2D-truncated build on the JAX package's interpolation
    points serves its J/K to 1e-8 relative, with ``use_trs=False`` too."""
    cell_j, cell = he2_box
    kpts = cell.get_kpts([2, 1, 1])
    dm = trs_dm(cell, kpts, 2)

    def jax_side():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            df_j = JaxISDF(cell_j, kpts, c0=10.0, m0=(9, 9, 11), verbose=0,
                           trunc="2d").build()
        return (df_j.mask,) + tuple(df_j.get_jk(dm))

    mask_j, vj_j, vk_j = recorded("omega_trunc/compressed_2d", jax_side)
    for use_trs in (True, False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 11), verbose=0,
                         trunc="2d", use_trs=use_trs, validate=True,
                         device="cpu").build(mask=mask_j)
        vj, vk = df.get_jk(dm)
        assert _rel(vj, vj_j) < 1e-8 and _rel(vk, vk_j) < 1e-8, use_trs


def test_trunc_guards(he2_box, box_0d):
    """omega with truncation stays refused, as in the JAX package.  exxdiv
    with a truncated kernel adds the kernel's own probe-charge constant (0
    in 0d) on both providers, and the SCF classes adopt the provider's
    truncation and refuse a different one."""
    _, cell = he2_box
    kpts, df = box_0d
    dm = np.eye(2)[None].astype(complex)
    with pytest.raises(NotImplementedError):
        df.get_jk(dm, omega=0.3)
    assert _maxerr(df.get_jk(dm, exxdiv="ewald")[1], df.get_jk(dm)[1]) == 0
    pw = PWDF(cell, kpts, trunc="0d", device="cpu")
    assert _maxerr(pw.get_jk(dm, exxdiv="ewald")[1], pw.get_jk(dm)[1]) == 0
    assert KRHF(cell, kpts, df, verbose=0, device="cpu").trunc == df.trunc
    with pytest.raises(ValueError):
        KRHF(cell, kpts, df, trunc=("0d", 1.0), verbose=0, device="cpu")
    with pytest.raises(ValueError):
        KRHF(cell, kpts, df, trunc="2d", verbose=0, device="cpu")


def test_trunc_serialization_roundtrip(tmp_path, he2_box, box_0d):
    """A truncated state carries its spec through the .npz format: the
    port's own round trip (1e-12), the JAX package's state into the port
    and the port's into the JAX package (same J/K to 1e-12 relative)."""
    cell_j, cell = he2_box
    kpts, df = box_0d
    dm = trs_dm(cell, kpts, 2)
    path_j = tmp_path / "jax_trunc_state.npz"

    def jax_side():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            df_j = JaxISDF(cell_j, kpts, c0=10.0, m0=(9, 9, 11), verbose=0,
                           trunc="0d").build()
        df_j.save(str(path_j))
        return ((np.frombuffer(path_j.read_bytes(), dtype=np.uint8),
                 np.asarray(df_j.trunc[1])) + tuple(df_j.get_jk(dm))
                + (df_j.get_jk(dm, exxdiv="ewald")[1],))

    # the JAX package's file, byte for byte, and its J/K
    raw, rc_j, vj_j, vk_j, vk_je = recorded("omega_trunc/state_file",
                                            jax_side)
    path = str(tmp_path / "trunc_state.npz")
    df.save(path)
    df2 = FFTISDF.load(path, cell, kpts, device="cpu")
    assert df2.trunc == df.trunc
    vj1, vk1 = df.get_jk(dm)
    vj2, vk2 = df2.get_jk(dm)
    assert _maxerr(vj1, vj2) < 1e-12 and _maxerr(vk1, vk2) < 1e-12
    df3 = JaxISDF.load(path, cell_j, kpts)
    assert df3.trunc == df.trunc
    vj3, vk3 = df3.get_jk(dm)
    assert _rel(vj1, vj3) < 1e-12 and _rel(vk1, vk3) < 1e-12
    path_j.write_bytes(raw.tobytes())
    df4 = FFTISDF.load(str(path_j), cell, kpts, device="cpu")
    assert df4.trunc == ("0d", float(rc_j))
    vj4, vk4 = df4.get_jk(dm)
    assert _rel(vj4, vj_j) < 1e-12 and _rel(vk4, vk_j) < 1e-12
    # the reloaded spec drives the probe-charge constant of the kernel
    assert _rel(df4.get_jk(dm, exxdiv="ewald")[1], vk_je) < 1e-12
