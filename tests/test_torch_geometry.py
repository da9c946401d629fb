"""The geometry drivers of the PyTorch port (``scf.optimize``,
``scf.hessian``, ``scf.md``, ``scf.phonon``, ``scf.elastic``, ``scf.eos``)
on the JAX derivative tests' H2, He and LiH fixtures, each run once from
scratch on the CPU (``md.npt_kernel`` on the card, chip_smoke.py phase
12a) and held to the JAX package's recorded result
(tests/data/jax_port_refs.json, ``derivatives/drivers``), plus the
numpy-only identities of the drivers (Voigt packing, the Birch-Murnaghan
fit, harmonic thermodynamics, Maxwell-Boltzmann sampling) and the SCF
clone they share.

Both packages run these SCFs without DIIS (``diis_space=1``): the JAX
package builds the energy-weighted density from the orbitals of its last
DIIS-extrapolated Fock, which at a warm start mixes in the previous
geometry's Fock (ROADMAP section 3); without DIIS its orbitals are those
of the converged density, which the port always uses.  Each package
converges its own SCF at every geometry, so the records agree to that
convergence propagated through the driver: energies to 1e-8 Ha, positions
to 1e-6 bohr, FD Hessians to 1e-5 Ha/bohr^2, wavenumbers to 1e-2 cm^-1.
A BFGS run's final iterate sits anywhere below the force gate, so a
relaxation is held to its first steps and to its minimum (energy 1e-7,
bond 2e-3 bohr).
"""
import numpy as np
import pytest

import torch_deriv_fixtures as fx
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.scf import (KRHF, KUHF, KUKS, DeviceKRHF, DeviceKUHF,
                                   DeviceKUKS)
from fftisdf_tpu_torch.scf import elastic, eos, md, phonon
from fftisdf_tpu_torch.scf import hessian as scf_hess
from fftisdf_tpu_torch.scf import optimize as scf_opt
from test_torch_autodiff_forces import REFS

DRV = REFS["drivers"]
CPU = dict(verbose=0, device="cpu")


def _krhf(cell, conv_tol=1e-10, cls=KRHF, **kw):
    return cls(cell, cell.get_kpts([1, 1, 1]), conv_tol=conv_tol,
               diis_space=1, **CPU, **kw)


def test_relaxation_matches_jax():
    ref = DRV["opt_h2_rhf"]
    cell = fx.h2(Cell, Shell, d=2.0)
    res = scf_opt.kernel(_krhf(cell), fmax=5e-4, max_steps=15)
    assert res.converged and ref["converged"]
    np.testing.assert_allclose([e for _, e, _ in res.trajectory[:3]],
                               ref["energies"][:3], atol=1e-8)
    assert abs(res.energy - ref["energy"]) < 1e-7
    bond = lambda p: np.linalg.norm(np.asarray(p)[1] - np.asarray(p)[0])
    assert abs(bond(res.positions) - bond(ref["positions"])) < 2e-3
    gv = res.grad - res.grad.mean(axis=0, keepdims=True)
    assert np.abs(gv).max() < 5e-4
    assert abs(res.mf.e_tot - res.energy) < 1e-8


def test_relax_cell_matches_jax():
    ref = DRV["relax_cell_lih"]
    cell = fx.lih(Cell, Shell, 6.8)
    res = scf_opt.relax_cell(_krhf(cell), smax=1e-9, max_steps=1,
                             relax_atoms=False, re_anchor=0.5)
    e = [t[0] for t in res.trajectory]
    assert all(b < a for a, b in zip(e, e[1:]))
    np.testing.assert_allclose(e, ref["energies"], atol=1e-8)
    np.testing.assert_allclose(res.cell.a, ref["a"], atol=1e-6)
    assert abs(res.energy - res.mf.e_tot) < 1e-10


def test_relax_cell_re_anchor_is_off_roundoff():
    """Capped strain steps (0.02 each) put LiH's accumulated strain on the
    re-anchoring threshold 0.04 in exact arithmetic: 0.039999999999999959
    at step 5 on the CPU, above 0.04 on the H100, which re-anchored a step
    earlier and stopped 1.9e-3 bohr away (examples/lih_variable_cell.py
    at its defaults).  The decision carries a 1e-9 margin, so a threshold 1e-15
    below 0.04 does not re-anchor there either (without the margin it
    does, and step 5 starts from a strain of 0)."""
    cell = fx.lih(Cell, Shell, 6.8)
    seen = []
    scf_opt.relax_cell(
        _krhf(cell), smax=1e-9, max_steps=5, relax_atoms=False,
        re_anchor=0.039999999999999,
        callback=lambda step, eps, dfrac, e, s, g: seen.append(
            float(np.abs(eps).max())))
    assert seen[3] == 0.0 and abs(seen[5] - 0.04) < 1e-12, seen


@pytest.mark.parametrize("backend", ["pw", "isdf", "isdf-device"])
def test_hessian_matches_jax(backend):
    """``isdf-device``: a device-resident reference (DeviceKRHF on the ISDF
    state), whose displaced SCFs serve K from the frozen-point provider's
    image-space metric."""
    cell = fx.h2(Cell, Shell, d=1.30, mesh=14)
    df = None
    if backend != "pw":
        ref = DRV["hessian_h2_isdf"]
        df = FFTISDF(cell, cell.get_kpts([1, 1, 1]), c0=40.0,
                     m0=tuple(ref["m0"]), **CPU).build(
                         mask=np.asarray(ref["mask"]))
    if backend == "isdf-device":
        mf = _krhf(cell, conv_tol=1e-11, cls=DeviceKRHF, with_df=df)
    else:
        mf = _krhf(cell, conv_tol=1e-11)
    mf.kernel()
    if backend == "pw":
        ref = DRV["hessian_h2"]
        h, g0 = scf_hess.kernel(mf, step=1.5e-3)
        np.testing.assert_allclose(g0, ref["g0"], atol=1e-7)
        wav, _ = scf_hess.frequencies(cell, h)
        np.testing.assert_allclose(wav[3:], ref["freqs"][3:], atol=1e-2)
        assert np.abs(wav[:3]).max() < 0.05 * np.abs(wav).max()
        np.testing.assert_allclose(h, ref["hess"], atol=1e-5)
        assert np.abs(h - h.T).max() == 0.0
    else:
        # the rows of the stretch coordinates (the row-restricted entry
        # point of scf.phonon), each displaced SCF on a frozen-point re-fit
        h, _ = scf_hess.kernel(mf, step=1.5e-3, two_electron="isdf", df=df,
                               rows=[2, 5])
        np.testing.assert_allclose(h, np.asarray(ref["hess"])[[2, 5]],
                                   atol=1e-5)


def test_md_matches_jax():
    """NVE (energy at the Verlet floor of tests/test_md.py), BAOAB and
    CSVR from the same seeds as the JAX records."""
    cell = fx.h2(Cell, Shell, d=1.4)
    res = md.kernel(_krhf(cell), dt_fs=0.3, nsteps=3, temperature=300.0,
                    seed=0)
    ref = DRV["md_nve"]
    np.testing.assert_allclose(res.energies, ref["energies"], atol=1e-8)
    np.testing.assert_allclose(res.positions, ref["positions"], atol=1e-6)
    assert np.abs(res.energies - res.energies[0]).max() < 3e-4
    m = md.atom_masses(cell)
    com0 = (m[:, None] * res.trajectory[0]["positions"]).sum(0) / m.sum()
    com1 = (m[:, None] * res.positions).sum(0) / m.sum()
    assert np.abs(com1 - com0).max() < 1e-6
    res = md.kernel(_krhf(cell), dt_fs=1.0, nsteps=2, temperature=600.0,
                    thermostat="langevin", friction_fs=2.0,
                    velocities0=np.zeros((2, 3)), seed=1)
    np.testing.assert_allclose([r["e_kin"] for r in res.trajectory],
                               DRV["md_langevin"]["e_kin"], atol=1e-8)
    res = md.kernel(_krhf(cell), dt_fs=0.5, nsteps=2, temperature=300.0,
                    thermostat="csvr", tau_fs=1.0, seed=2)
    np.testing.assert_allclose(res.temperatures, DRV["md_csvr"]["temps"],
                               rtol=1e-6)


def test_phonon_matches_jax():
    ref = DRV["phonon_he_chain"]
    cell = fx.he_chain(Cell, Shell)
    res = phonon.kernel(_krhf(cell, conv_tol=1e-11), (1, 1, 2), step=2e-3,
                        asr=False)
    np.testing.assert_allclose(res.fc, ref["fc"], atol=1e-5)
    np.testing.assert_allclose(res.frequencies(cell.get_kpts([1, 1, 2])),
                               ref["freqs"], atol=1e-2)
    assert abs(res.e_sc - ref["e_sc"]) < 1e-8
    fc = phonon.enforce_asr(res.fc)
    w0 = phonon.frequencies(fc, res.masses_me, res.images, np.zeros(3))[0]
    assert np.abs(w0).max() < 1e-3


def test_elastic_and_eos_match_jax():
    cell = fx.he_sc(Cell, Shell)
    mf = _krhf(cell, conv_tol=1e-11)
    mf.kernel()
    ref = DRV["elastic_he_sc"]
    res = elastic.kernel(mf, step=3e-3, components=(0, 1))
    np.testing.assert_allclose(res.c[:, :2], ref["c01"], atol=1e-6)
    np.testing.assert_allclose(res.sigma0, ref["sigma0"], atol=1e-9)
    assert abs(res.e0 - ref["e0"]) < 1e-8
    c = res.c
    assert abs(c[0, 1] - c[1, 0]) < 5e-4 * abs(c[0, 0])
    ref = DRV["eos_he_sc"]
    res = eos.kernel(mf, scales=np.linspace(0.97, 1.03, 5))
    np.testing.assert_allclose(res.energies, ref["energies"], atol=1e-8)
    np.testing.assert_allclose(res.pressures, ref["pressures"], atol=1e-8)
    for k in ("v0", "b0", "bp"):
        assert abs(res.fit[k] - ref[k]) <= 1e-5 * abs(ref[k]), k
    p_fit = eos.bm_pressure(res.fit["poly"], res.volumes)
    assert np.abs(p_fit - res.pressures).max() < 5e-3 * np.abs(
        res.pressures).max()


@pytest.mark.parametrize("cls, kw", [
    (KUHF, dict(init_spin={0: 1}, spin_bias=0.3, bias_cycles=2,
                smearing=1e-2, smearing_method="gauss")),
    (KUKS, dict(xc="pbe", hubbard={0: (0, 0.2)}, init_spin={0: 1})),
    (DeviceKUHF, dict(init_spin={0: 1}, damp=0.2)),
    (DeviceKUKS, dict(xc="lda", exxdiv=None, smearing=1e-3)),
])
def test_clone_keeps_knobs(cls, kw):
    """_clone_mf carries every constructor knob of the port's SCF classes
    (the KUHF-only spin bias, smearing, xc, +U, damping, dtype, device)
    and none of the outputs."""
    cell = fx.lih(Cell, Shell, 6.8, mesh=10)
    mf = cls(cell, cell.get_kpts([1, 1, 1]), conv_tol=1e-7, **CPU, **kw)
    c = scf_opt._clone_mf(mf, cell)
    assert type(c) is cls and c is not mf
    for k, v in kw.items():
        assert getattr(c, k) == v, k
    assert c.conv_tol == 1e-7 and c.device == mf.device
    assert c.dtype == mf.dtype and c.converged is False and c.e_tot is None


def test_voigt_and_bm3_identities():
    rng = np.random.default_rng(3)
    e = rng.standard_normal(6)
    eps = elastic.voigt_strain(e)
    assert np.abs(eps - eps.T).max() == 0.0
    back = elastic.stress_to_voigt(eps)
    np.testing.assert_allclose(back[:3], e[:3], rtol=1e-15)
    np.testing.assert_allclose(back[3:], e[3:] / 2.0, rtol=1e-15)
    rng = np.random.default_rng(7)
    for _ in range(4):
        e0, v0 = rng.uniform(-10.0, 10.0), rng.uniform(50.0, 300.0)
        b0, bp = rng.uniform(1e-3, 5e-2), rng.uniform(2.0, 7.0)
        v = np.linspace(0.85 * v0, 1.15 * v0, 9)
        fit = eos.fit_birch_murnaghan(v, eos.birch_murnaghan(v, e0, v0, b0,
                                                             bp))
        np.testing.assert_allclose(fit["v0"], v0, rtol=1e-9)
        np.testing.assert_allclose(fit["b0"], b0, rtol=1e-7)
        np.testing.assert_allclose(fit["bp"], bp, rtol=1e-6)


def test_einstein_thermodynamics_and_sampling():
    cell = fx.he_chain(Cell, Shell)
    m = phonon.atom_masses_me(cell)
    w0, t = 1.2e-3, 300.0
    fc = np.zeros((1, 3, 2, 1, 3))
    fc[0, :, 0, 0, :] = np.eye(3) * (w0 ** 2) * m[0]
    images = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.2]])
    out = phonon.thermodynamics(fc, m, images, cell, (1, 1, 4), t)
    x = w0 / (phonon.KB_HA * t)
    np.testing.assert_allclose(out["zpe"], 1.5 * w0, rtol=1e-12)
    np.testing.assert_allclose(
        out["f_vib"], 3 * (w0 / 2 + phonon.KB_HA * t * np.log1p(-np.exp(-x))),
        rtol=1e-12)
    masses = md.atom_masses(cell, masses=[1.008, 15.999] * 500)
    v = md.maxwell_boltzmann(masses, t, np.random.default_rng(7))
    ek = 0.5 * float((masses[:, None] * v * v).sum())
    np.testing.assert_allclose(
        ek, 0.5 * (3 * len(masses) - 3) * md.KB_HARTREE * t, rtol=1e-12)


def test_strained_kpoints_deform_with_cell():
    """Off the Gamma point the strained SCFs of ``elastic``/``eos`` take
    the k-points at the reference's fractional coordinates (the
    convention ``scf.stress`` differentiates): the strain Lagrangian then
    equals each strained energy (``elastic.kernel`` asserts it to 1e-7).
    With the reference's Cartesian k-points (the JAX package's elastic and
    EOS drivers) the strained SCF converges another functional."""
    from fftisdf_tpu_torch.scf import stress

    cell = fx.he_sc(Cell, Shell)
    kpts = cell.get_kpts([1, 1, 2])
    mf = KRHF(cell, kpts, conv_tol=1e-11, diis_space=1, **CPU)
    mf.kernel()
    res = elastic.kernel(mf, step=3e-3, components=(2,))
    assert np.isfinite(res.c[:, 2]).all() and res.c[2, 2] != 0.0
    eps = elastic.voigt_strain([0.0, 0.0, 3e-3, 0.0, 0.0, 0.0])
    cart = KRHF(elastic.strained_cell(cell, eps), kpts, conv_tol=1e-11,
                diis_space=1, **CPU)
    cart.kernel(dm0=mf.dm)
    val, _, _ = stress.make_cell_grad_fn(cell, kpts, device="cpu")(cart,
                                                                  eps=eps)
    assert abs(val - cart.e_tot) > 1e-6


# --------------- tests/test_eos.py's analytic oracles (numpy, no SCF)
def _einstein_f(v, t, w0, gamma, v0):
    """Free energy of one Einstein mode w(V) = w0 (V/v0)^(-gamma)."""
    w = w0 * (v / v0) ** (-gamma)
    f = w / 2.0
    if t > 0:
        f = f + phonon.KB_HA * t * np.log1p(-np.exp(-w / (phonon.KB_HA * t)))
    return f


def test_qha_grueneisen_oracle():
    """tests/test_eos.py::test_qha_grueneisen_oracle: QHA on a BM3
    energy plus one Einstein mode; V0(T) within 2e-3 of a dense direct
    minimisation of the exact F(V, T), thermal expansion positive; every
    output equal to the JAX package's qha on the same inputs (1e-12)."""
    from fftisdf_tpu.scf import eos as jax_eos

    e0, v0, b0, bp = -2.0, 150.0, 5e-3, 4.3
    w0, gamma = 1.5e-3, 1.8
    vols = np.linspace(0.92 * v0, 1.12 * v0, 9)
    e_el = eos.birch_murnaghan(vols, e0, v0, b0, bp)
    ts = np.array([0.0, 150.0, 300.0, 600.0])
    f_vib = np.array([[_einstein_f(v, t, w0, gamma, v0) for v in vols]
                      for t in ts])
    out = eos.qha(vols, e_el, f_vib, ts)
    vfine = np.linspace(vols[0], vols[-1], 20001)
    for i, t in enumerate(ts):
        f_exact = eos.birch_murnaghan(vfine, e0, v0, b0, bp) \
            + _einstein_f(vfine, t, w0, gamma, v0)
        np.testing.assert_allclose(out["v0"][i], vfine[np.argmin(f_exact)],
                                   rtol=2e-3)
    assert out["v0"][0] > v0
    assert np.all(np.diff(out["v0"]) > 0)
    assert out["b0"][-1] < out["b0"][0]
    assert np.all(out["alpha_v"][1:] > 0)
    ref = jax_eos.qha(vols, e_el, f_vib, ts)
    for key in ("v0", "b0", "alpha_v"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-12, atol=0)


def test_gruneisen_einstein_oracle():
    """tests/test_eos.py::test_gruneisen_einstein_oracle: power-law mode
    gammas recovered to 1e-12 with the zero acoustic column masked, and
    the closed-form Grueneisen alpha_V within 5% of the explicit QHA
    minimisation; equal to the JAX package's gruneisen (1e-12)."""
    from fftisdf_tpu.scf import eos as jax_eos

    e0, v0, b0, bp = -2.0, 150.0, 5e-3, 4.3
    w0_cm = np.array([300.0, 700.0, 1100.0])
    g_true = np.array([1.2, 1.8, 0.9])
    vols = np.linspace(0.95 * v0, 1.05 * v0, 7)
    freqs = np.array([
        np.concatenate([[0.0], w0_cm * (v / v0) ** (-g_true)])[None, :]
        for v in vols])
    out = eos.gruneisen(vols, freqs)
    np.testing.assert_allclose(out["gamma"][0, 1:], g_true, atol=1e-12)
    assert out["gamma"][0, 0] == 0.0 and not bool(out["mask"][0, 0])
    t = 300.0
    w_ha = w0_cm / scf_hess.HARTREE_TO_CM1

    def f_vib(v, ti):
        return sum(_einstein_f(v, ti, w, g, v0) for w, g in zip(w_ha,
                                                                g_true))

    e_el = eos.birch_murnaghan(vols, e0, v0, b0, bp)
    ts = np.array([t - 5.0, t, t + 5.0])
    fv = np.array([[f_vib(v, ti) for v in vols] for ti in ts])
    ref = eos.qha(vols, e_el, fv, ts)
    out = eos.gruneisen(vols, freqs, temperature=t, b0=ref["b0"][1],
                        v0=ref["v0"][1])
    assert out["alpha_v"] > 0.0
    np.testing.assert_allclose(out["alpha_v"], ref["alpha_v"][1], rtol=0.05)
    assert 0.9 < out["gamma_mean"] < 1.8
    out_j = jax_eos.gruneisen(vols, freqs, temperature=t, b0=ref["b0"][1],
                              v0=ref["v0"][1])
    for key in ("gamma", "alpha_v", "gamma_mean"):
        np.testing.assert_allclose(out[key], out_j[key], rtol=1e-12, atol=0)
