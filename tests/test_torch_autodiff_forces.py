"""Differentiable ISDF and analytic forces of the PyTorch port
(``isdf.autodiff``, ``scf.grad``) against the JAX package.

The JAX side is recorded in tests/data/jax_port_refs.json's
``derivatives`` section (``tools/jax_port_refs.py derivatives``): for each
case of ``tests/torch_deriv_fixtures.py`` the JAX package's converged
density, orbitals and ISDF mask, and its Lagrangian value and gradient
there.  The port evaluates its Lagrangian on the same density and mask;
value and gradient agree to 1e-8 relative (to |E| and max|g|) for the
plane-wave and ISDF backends, RHF, UHF, LDA/PBE, +U, SCAN, HSE06 and
exxdiv 'ewald'.  The ERI gradient of tests/test_autodiff.py is held to the
JAX record, to central differences (1x1x2, as there), and across
time-reversal halving and
sector chunking at the JAX test's tolerances; the port's own ISDF force
is held to a central difference (Richardson, +-h and +-2h) of its own
re-converged energies.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_deriv_fixtures as fx
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.isdf.autodiff import eri_grad_fn, isdf_state_fn
from fftisdf_tpu_torch.lattice import kpoints as kpt_mod
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.linalg import solvers
from fftisdf_tpu_torch.scf import KRHF, KUHF, integrals
from fftisdf_tpu_torch.scf import grad as scf_grad
from torch_test_threads import two_torch_threads  # noqa: F401

REFS = json.loads((Path(__file__).resolve().parent / "data"
                   / "jax_port_refs.json").read_text())["derivatives"]
CPU = torch.device("cpu")


def _arr(rec):
    return (np.asarray(rec["re"]) + 1j * np.asarray(rec["im"])).reshape(
        rec["shape"])


def jax_scf(cell, kpts, name, kw):
    """The JAX package's converged SCF of a case, as the attributes the
    port's derivative layer reads."""
    rec = REFS["cases"][name]
    return types.SimpleNamespace(
        cell=cell, kpts=kpts, dm=_arr(rec["dm"]),
        mo_coeff=_arr(rec["mo_coeff"]),
        mo_energy=np.asarray(rec["mo_energy"]),
        mo_occ=np.asarray(rec["mo_occ"]), e_tot=rec["e_tot"], device=CPU,
        trunc=None, converged=True, xc=kw.get("xc"),
        hubbard=kw.get("hubbard"), exxdiv=kw.get("exxdiv"))


def frozen_df(cell, kpts):
    """An FFTISDF that carries the JAX package's mask (the derivative
    layer reads the mask, m0, solver and rcond)."""
    df = FFTISDF(cell, kpts, m0=fx.ISDF_BUILD["m0"], c0=fx.ISDF_BUILD["c0"],
                 verbose=0, device="cpu")
    df.mask = np.asarray(REFS["isdf_mask"])
    return df


@pytest.fixture(scope="module")
def he2():
    cell = fx.he2_strain(Cell, Shell)
    return cell, cell.get_kpts([1, 1, 2])


@pytest.mark.parametrize("name, cls, kw, backend", fx.CASES,
                         ids=[c[0] for c in fx.CASES])
def test_forces_match_jax(he2, name, cls, kw, backend):
    cell, kpts = he2
    rec = REFS["cases"][name]
    mf = jax_scf(cell, kpts, name, kw)
    df = frozen_df(cell, kpts) if backend == "isdf" else None
    g, val = scf_grad.kernel(mf, two_electron=backend, df=df)
    g_ref = np.asarray(rec["grad"])
    assert abs(val - rec["value"]) <= 1e-8 * abs(rec["value"])
    assert abs(val - rec["e_tot"]) <= 1e-8 * abs(rec["e_tot"])
    assert np.abs(g - g_ref).max() <= 1e-8 * np.abs(g_ref).max()


def test_port_scf_forces_match_jax(he2):
    """The port's own SCF (plane-wave and ISDF on the JAX mask), then its
    forces: the JAX package's forces to 1e-7 of max|g|."""
    cell, kpts = he2
    mf = KUHF(cell, kpts, verbose=0, conv_tol=1e-11, device="cpu")
    mf.kernel()
    g, val = scf_grad.kernel(mf)
    ref = REFS["cases"]["pw_uhf"]
    assert abs(val - ref["value"]) < 1e-8
    assert np.abs(g - ref["grad"]).max() <= 1e-7 * np.abs(ref["grad"]).max()
    df = FFTISDF(cell, kpts, verbose=0, device="cpu",
                 **fx.ISDF_BUILD).build(mask=np.asarray(REFS["isdf_mask"]))
    mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-11, device="cpu")
    mf.kernel()
    g, val = scf_grad.kernel(mf, two_electron="isdf", df=df)
    ref = REFS["cases"]["isdf_rhf"]
    assert abs(val - ref["value"]) < 1e-8
    assert np.abs(g - ref["grad"]).max() <= 1e-7 * np.abs(ref["grad"]).max()


def test_isdf_force_vs_finite_difference():
    """The port's ISDF force (frozen mask) against central differences of
    its own re-converged ISDF energies along the He-He stretch; the
    reference geometry is displaced so the force is not zero."""
    base = fx.he2_strain(Cell, Shell)
    kpts = base.get_kpts([1, 1, 2])

    def cell_at(dz):
        pos = base.atom_coords().copy()
        pos[1, 2] += 0.1 + dz
        return base.copy(atom=[(s, p) for s, p in
                               zip(base.atom_symbols(), pos)]).build()

    def scf(dz, mask=None):
        cell = cell_at(dz)
        df = FFTISDF(cell, kpts, verbose=0, device="cpu",
                     **fx.ISDF_BUILD).build(mask=mask)
        mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-12, device="cpu")
        mf.kernel()
        assert mf.converged
        return mf, df

    mf0, df0 = scf(0.0)
    g, val = scf_grad.kernel(mf0, two_electron="isdf", df=df0)
    assert abs(val - mf0.e_tot) < 1e-9
    h = 2e-3
    e = {m: scf(m * h, df0.mask)[0].e_tot for m in (-2, -1, 1, 2)}
    # Richardson: the +-h and +-2h central differences, O(h^4)
    fd = (8.0 * (e[1] - e[-1]) - (e[2] - e[-2])) / (12.0 * h)
    assert abs(g[1, 2]) > 1e-3
    assert abs(g[1, 2] - fd) < 5e-7, (g[1, 2], fd)


def test_warm_started_scf_force():
    """The force of an SCF warm-started from another geometry's density
    equals the cold-started one: W comes from the eigenpairs of the
    converged density's own Fock (``scf.grad.density_orbitals``).  The
    orbitals the host loop reports come from its last DIIS-extrapolated
    Fock, which here mixes in the first cycle's Fock of the previous
    geometry's density; W built from them (the JAX package's) moves the
    force by 3e-4 Ha/bohr."""
    import types

    base = fx.h2(Cell, Shell, d=1.4)
    kpts = base.get_kpts([1, 1, 1])
    mf0 = KRHF(base, kpts, verbose=0, conv_tol=1e-10, device="cpu")
    mf0.kernel()
    cell = base.copy(atom=[("H", (4.0, 4.0, 3.30882011)),
                           ("H", (4.0, 4.0, 4.69117989))]).build()
    warm = KRHF(cell, kpts, verbose=0, conv_tol=1e-10, device="cpu")
    warm.kernel(dm0=mf0.dm)
    cold = KRHF(cell, kpts, verbose=0, conv_tol=1e-10, device="cpu")
    cold.kernel()
    g_warm, _ = scf_grad.kernel(warm)
    g_cold, _ = scf_grad.kernel(cold)
    assert np.abs(g_warm - g_cold).max() < 1e-8
    own = types.SimpleNamespace(**{k: getattr(warm, k) for k in (
        "cell", "kpts", "dm", "mo_energy", "mo_coeff", "mo_occ", "device",
        "exxdiv")}, trunc=None, xc=None, hubbard=None)
    g_own, _ = scf_grad.kernel(own)
    assert np.abs(g_own - g_cold).max() > 1e-4


def test_device_loop_forces_match_jax(he2):
    """DeviceKRHF (restricted results of the spin-split device step) and
    DeviceKUHF give the JAX package's forces on its mask (1e-7)."""
    from fftisdf_tpu_torch.scf import DeviceKRHF, DeviceKUHF

    cell, kpts = he2
    df = FFTISDF(cell, kpts, verbose=0, device="cpu",
                 **fx.ISDF_BUILD).build(mask=np.asarray(REFS["isdf_mask"]))
    ref = REFS["cases"]["isdf_rhf"]
    for cls in (DeviceKRHF, DeviceKUHF):
        mf = cls(cell, kpts, df, verbose=0, conv_tol=1e-11, device="cpu")
        mf.kernel()
        g, val = scf_grad.kernel(mf, two_electron="isdf", df=df)
        assert abs(val - mf.e_tot) < 1e-9, cls.__name__
        assert np.abs(g - ref["grad"]).max() <= 1e-7 * np.abs(
            ref["grad"]).max(), cls.__name__


def test_ewald_fn_matches_host_sum(he2):
    cell, _ = he2
    e = scf_grad.ewald_fn(cell, device="cpu")(cell.atom_coords())
    assert abs(float(e) - integrals.ewald(cell)) < 1e-10


def test_grad_guards(he2):
    cell, kpts = he2
    mf = jax_scf(cell, kpts, "pw_lda", {"xc": "lda"})
    with pytest.raises(ValueError, match="stationary"):
        scf_grad.make_grad_fn(cell, kpts, xc="pbe", device="cpu")(mf)
    mf = jax_scf(cell, kpts, "pw_rhf_ewald", {"exxdiv": "ewald"})
    with pytest.raises(ValueError, match="exxdiv"):
        scf_grad.make_grad_fn(cell, kpts, device="cpu")(mf)
    with pytest.raises(NotImplementedError):
        scf_grad.make_energy_fn(cell, kpts, exxdiv="vcut_sph", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        isdf_state_fn(cell, kpts, REFS["isdf_mask"], m0=(11, 11, 11),
                      dev_mesh=object(), device="cpu")
    mf.trunc = ("0d", 3.0)
    with pytest.raises(NotImplementedError):
        scf_grad.kernel(mf)


def test_ridge_lam_is_rcond():
    """The ridge shift leaves the autograd graph as a float: after the
    Jacobi scaling every kept diagonal is 1, so lam = rcond exactly and
    its derivative vanishes (as the JAX package's stop_gradient)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 9)) + 1j * rng.standard_normal((6, 9))
    a = torch.as_tensor(x @ x.conj().T).requires_grad_(True)
    d, _, _, lam = solvers._ridge_factor(a, 1e-10)
    assert lam == pytest.approx(1e-10, rel=1e-14)
    _, _, a_s = solvers._jacobi(a)
    (g,) = torch.autograd.grad(torch.diagonal(a_s).real.sum(), a)
    assert float(g.abs().max()) < 1e-14 * float(a.abs().max())


# ------------------------------------------------------------- ERI gradient
@pytest.fixture(scope="module")
def probe_cell():
    return fx.he2_probe(Cell, Shell)


def _probe(nao, real=False):
    rng = np.random.default_rng(0)
    p = rng.standard_normal((nao,) * 4)
    return p if real else p + 1j * rng.standard_normal((nao,) * 4)


@pytest.mark.parametrize("km", ["1x1x2", "1x1x3"])
def test_eri_grad_matches_jax_and_fd(probe_cell, km):
    rec = REFS["eri_grad"][km]
    kpts = probe_cell.get_kpts([int(v) for v in km.split("x")])
    k2c = kpt_mod.get_kconserv2(probe_cell, kpts)
    pos0 = probe_cell.atom_coords()
    vg = eri_grad_fn(probe_cell, kpts, rec["mask"], tuple(rec["kidx"]), k2c,
                     m0=tuple(rec["m0"]), device="cpu")
    probe = _probe(probe_cell.nao_nr())
    val, g = vg(pos0, probe)
    g = g.numpy()
    g_ref = np.asarray(rec["grad"])
    assert abs(float(val) - rec["value"]) <= 1e-8 * abs(rec["value"])
    assert np.abs(g - g_ref).max() <= 1e-8 * np.abs(g_ref).max()
    assert np.abs(g).max() > 1e-4
    if km != "1x1x2":
        return
    # central differences on two components, as tests/test_autodiff.py
    h = 1e-5
    for ia, d in [(0, 2), (1, 1)]:
        pp, pm = pos0.copy(), pos0.copy()
        pp[ia, d] += h
        pm[ia, d] -= h
        fd = (float(vg(pp, probe)[0]) - float(vg(pm, probe)[0])) / (2 * h)
        assert abs(g[ia, d] - fd) <= 2e-5 * abs(fd) + 1e-8


def test_state_fn_matches_build(probe_cell):
    """isdf_state_fn at the reference geometry equals the forward build on
    the same mask (tests/test_autodiff.py's tolerances)."""
    kpts = probe_cell.get_kpts([1, 1, 3])
    rec = REFS["eri_grad"]["1x1x3"]
    df = FFTISDF(probe_cell, kpts, m0=tuple(rec["m0"]), verbose=0,
                 device="cpu").build(mask=np.asarray(rec["mask"]))
    state = isdf_state_fn(probe_cell, kpts, rec["mask"], m0=df.m0,
                          device="cpu")
    with torch.no_grad():
        x_k, wq = state(probe_cell.atom_coords())
    assert float((x_k - df.x_k).abs().max()) < 1e-10
    scale = float(df.wq.abs().max())
    assert float((wq - df.wq).abs().max()) < 5e-6 * scale


@pytest.mark.parametrize("variant", ["no_trs", "chunked", "one_chunk",
                                     "remat"])
def test_state_variants_agree(probe_cell, variant):
    """Time-reversal halving, sector chunking (one canonical sector a chunk,
    or one chunk) and the fit-factor remat reproduce the single-shot
    value and gradient on 1x1x3, where sectors 1 and 2 are a mirror pair
    (tests/test_autodiff.py: rtol 5e-6 / 1e-9, atol 1e-5 / 2e-6 of
    max(1, max|g|); rcond 1e-8 as there)."""
    kpts = probe_cell.get_kpts([1, 1, 3])
    rec = REFS["eri_grad"]["1x1x3"]
    k2c = kpt_mod.get_kconserv2(probe_cell, kpts)
    nip = len(rec["mask"])
    per_sector_gb = 9 * 9 * 11 * nip * 16 / 1e9
    kw = {"no_trs": dict(use_trs=False),
          "chunked": dict(max_memory_gb=2 * per_sector_gb),
          "one_chunk": dict(max_memory_gb=1e3),
          "remat": dict(remat=True)}[variant]
    kidx = (0, 2, 1, 0) if variant == "no_trs" else (0, 1, 1, 0)
    probe = _probe(probe_cell.nao_nr(), real=variant != "no_trs")

    def run(**extra):
        vg = eri_grad_fn(probe_cell, kpts, rec["mask"], kidx, k2c,
                         m0=tuple(rec["m0"]), rcond=1e-8, device="cpu",
                         **extra)
        v, g = vg(probe_cell.atom_coords(), probe)
        return float(v), g.numpy()

    v_ref, g_ref = run()
    v, g = run(**kw)
    scale = max(1.0, np.abs(g_ref).max())
    if variant == "no_trs":
        assert abs(v - v_ref) <= 5e-6 * abs(v_ref)
        assert np.abs(g - g_ref).max() <= 1e-5 * scale
    else:
        assert abs(v - v_ref) <= 1e-9 * abs(v_ref)
        assert np.abs(g - g_ref).max() <= 2e-6 * scale
