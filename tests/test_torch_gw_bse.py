"""The port's G0W0 (``scf.gw``) and BSE (``scf.bse``) against the JAX
package's, on the CPU in float64.

On the JAX package's interpolation points and converged orbitals
(tests/data/jax_port_refs.json, ``tools/jax_port_refs.py many_body``):
Sigma^c(iw) samples and G0W0 QP energies of the H2 chain (KRHF at gamma
and 1x1x2, KRKS-PBE at gamma) and of diamond gth-szv ke 50 1x1x2
(KRKS-PBE, with its static correction), and the BSE spectra (H2 KRHF;
diamond on the G0W0 energies), all at 1e-10 relative (QP energies at
1e-6 Ha, the Newton solve's stopping scale).  The orbitals are recorded
in a real gauge, where the JAX package's chi (A g A^T) equals the port's
(A g A^H); the port's methods are invariant under orbital phases, which
the JAX package's are not (ROADMAP §3).  The port alone,
with the JAX tests' gates: the Pade continuation of a rational function;
Sigma against the dense ov-space oracle (1e-8) and the analytic pole sum
(5e-3), QP energies against the pole oracle (1e-5 at the gap, 5e-2
overall); a KRHF reference's static correction is exactly zero and
KRKS(xc='hf') reproduces G0W0@KRHF; BSE with the bare W is CIS (1e-10),
static_w's chi0 -> 0 limit, the 2-electron MO-space oracle (1e-7) and
the scissor shift (1e-10).
"""
import numpy as np
import pytest
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.pw import get_eri_from_ao
from fftisdf_tpu_torch.scf import KRHF, KRKS
from fftisdf_tpu_torch.scf import bse as bse_mod
from fftisdf_tpu_torch.scf.gw import (_solve_qp, _static_correction,
                                      drpa_poles, g0w0, pade_eval,
                                      pade_thiele,
                                      sigma_c_from_poles, sigma_c_iw,
                                      sigma_c_ov_space)
from fftisdf_tpu_torch.scf.tddft import TDAOperator
from test_torch_mp2_rpa import REFS, h2_state, unpack, with_orbitals

NW = 24


def relmax(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _pbe_h2_gamma():
    cell, kpts, df, _ = h2_state("h2_gamma")
    return df, with_orbitals(KRKS(cell, kpts, df, xc="pbe", verbose=0,
                                  device="cpu"),
                             REFS["h2_gamma"]["krks_pbe"])


def test_pade_recovers_rational():
    poles = np.array([-1.3, -0.2, 0.4, 2.1])
    res = np.array([0.3, 0.8, 0.5, 1.1])

    def f(z):
        return np.sum(res / (z[..., None] - poles), axis=-1)

    w = np.linspace(0.05, 4.0, 12)
    model = pade_thiele(1j * w, f(1j * w))
    zq = np.array([0.1 + 0.02j, -0.5 + 0.05j, 1.0 + 0.1j])
    np.testing.assert_allclose(pade_eval(model, zq), f(zq), atol=1e-9)


def qp_close(e_qp, ref):
    """QP energies against the JAX package's: the Newton solve stops once
    a step is below 1e-8 Ha, and where it converges slowly (high virtuals)
    two solves whose Sigma samples agree to 1e-14 stop up to 1.2e-7 Ha
    apart (measured on the H2 chain); they are held to 1e-6 Ha, the
    samples to 1e-10, and the solve itself is held bitwise on the JAX
    package's own samples (test_g0w0_krhf_matches_jax)."""
    return float(np.abs(np.asarray(e_qp) - np.asarray(ref)).max()) < 1e-6


@pytest.mark.parametrize("key", ["h2_gamma", "h2_k2"])
def test_g0w0_krhf_matches_jax(key):
    _, _, df, mf = h2_state(key)
    rec = REFS[key]
    e_qp, info = g0w0(df, mf, nw=NW)
    assert qp_close(e_qp, rec["e_qp"])
    assert np.all(info["correction"] == 0.0)
    if key == "h2_gamma":
        sig = unpack(rec["sigma"])
        assert relmax(info["sigma_iw"], sig) < 1e-10
        assert info["efermi"] == pytest.approx(rec["efermi"], abs=1e-14)
        # the continuation and the QP solve (numpy, as in the JAX
        # package) on the JAX package's own samples give its energies
        idx = np.unique(np.linspace(0, int(NW * 0.75), 18).astype(int))
        e_host = [_solve_qp(mf.mo_energy[0][n], 0.0, pade_thiele(
            1j * info["iw"][idx], sig[0, n, idx]), rec["efermi"])
                  for n in range(sig.shape[1])]
        assert relmax([e for e, _ in e_host], rec["e_qp"][0]) < 1e-12
        assert relmax([z for _, z in e_host], rec["z"][0]) < 1e-12


def test_g0w0_pbe_matches_jax():
    """KRKS-PBE at gamma: the static correction -<vk>/2 - <vxc> and the
    QP energies."""
    df, ks = _pbe_h2_gamma()
    rec = REFS["h2_gamma"]
    e_qp, info = g0w0(df, ks, nw=NW)
    assert relmax(info["correction"], rec["pbe_correction"]) < 1e-10
    assert qp_close(e_qp, rec["pbe_e_qp"])


@pytest.fixture(scope="module")
def diamond_pbe():
    """(df, KRKS-PBE with the JAX orbitals) on diamond 1x1x2."""
    rec = REFS["diamond"]
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build(mask=np.asarray(rec["mask"]))
    ks = with_orbitals(KRKS(cell, kpts, df, xc="pbe", verbose=0,
                            device="cpu"), rec["pbe"])
    return df, ks


def test_diamond_gw_bse_match_jax(diamond_pbe):
    """G0W0@PBE (Sigma samples, static correction, QP energies) and BSE on
    the QP energies, on diamond 1x1x2."""
    df, ks = diamond_pbe
    rec = REFS["diamond"]["pbe"]
    e_qp, info = g0w0(df, ks, nw=NW)
    assert relmax(info["sigma_iw"], unpack(rec["sigma"])) < 1e-10
    assert relmax(info["correction"], rec["correction"]) < 1e-10
    assert qp_close(e_qp, rec["e_qp"])
    # BSE on the JAX package's QP energies: the spectrum is then held to
    # 1e-10, free of the QP solve's stopping point
    w, d = bse_mod.bse(ks, df, nroots=0, dense=True,
                       qp_energy=np.asarray(rec["e_qp"]))
    # Hermitian to the solve's roundoff (3.7e-8 measured; the JAX
    # package's A g A^T chi leaves 2.7e-3 on these inputs' phases)
    assert d["nonhermiticity"] < 1e-6
    assert relmax(w, rec["bse_qp"]) < 1e-10


def test_chi_is_gauge_invariant(diamond_pbe):
    """A phase on each orbital changes neither dRPA, Sigma^c(iw) nor the
    BSE spectrum (chi = A g A^H; the JAX package's A g A^T moves the dRPA
    energy by 0.17 Ha here, ROADMAP §3), nor kmp2."""
    import copy

    from fftisdf_tpu_torch.scf.mp2 import kmp2
    from fftisdf_tpu_torch.scf.rpa import drpa

    df, ks = diamond_pbe
    phases = np.exp(2j * np.pi * np.random.default_rng(0).random(
        (ks.mo_coeff.shape[0], ks.mo_coeff.shape[2])))
    ks2 = copy.copy(ks)
    ks2.mo_coeff = ks.mo_coeff * phases[:, None, :]

    def run(mf):
        return [drpa(df, mf, nw=12)[0], kmp2(df, mf)[0],
                sigma_c_iw(df, mf, nw=12)[0],
                bse_mod.bse(mf, df, q=1, nroots=0, dense=True)[0]]

    for a, b in zip(run(ks), run(ks2)):
        assert relmax(b, a) < 1e-10


def test_bse_matches_jax():
    _, _, df, mf = h2_state("h2_gamma")
    w, d = bse_mod.bse(mf, df, nroots=0, dense=True)
    assert d["nonhermiticity"] < 1e-10
    assert relmax(w, REFS["h2_gamma"]["bse"]) < 1e-10


@pytest.fixture(scope="module")
def gamma_oracle():
    """The H2 gamma state and its exact plane-wave MO ERI."""
    cell, kpts, df, mf = h2_state("h2_gamma")
    coords = cell.gen_uniform_grids()
    ao = make_evaluator(cell, kpts=kpts, device="cpu")(coords)[0]
    mo = ao @ torch.as_tensor(mf.mo_coeff[0])
    eri = get_eri_from_ao(cell, (mo,) * 4, np.zeros(3), coords).numpy()
    return cell, kpts, df, mf, eri


def test_sigma_iw_matches_dense_and_pole_oracles(gamma_oracle):
    _, _, df, mf, eri = gamma_oracle
    mo_e = mf.mo_energy[0]
    sigma, iw, ef, _ = sigma_c_iw(df, mf, nw=NW)
    sig_ref, _, ef_ref = sigma_c_ov_space(eri, mo_e, 1, nw=NW)
    assert abs(ef - ef_ref) < 1e-12
    np.testing.assert_allclose(sigma[0], sig_ref, atol=1e-8)
    om_s, resid, _ = drpa_poles(eri, mo_e, 1)
    sig_pole = sigma_c_from_poles(om_s, resid, ef, mo_e, 1, 1j * iw)
    np.testing.assert_allclose(sig_ref.T, sig_pole, atol=5e-3)

    e_qp, info = g0w0(df, mf, nw=NW)

    def qp_pole(n):
        e = mo_e[n]
        for _ in range(200):
            s = sigma_c_from_poles(om_s, resid, ef, mo_e, 1,
                                   np.array([e - ef + 0j]))[0, n].real
            e_new = mo_e[n] + s
            if abs(e_new - e) < 1e-12:
                break
            e = 0.5 * (e + e_new)
        return e

    qp_ref = np.array([qp_pole(n) for n in range(len(mo_e))])
    np.testing.assert_allclose(e_qp[0, :2], qp_ref[:2], atol=1e-5)
    np.testing.assert_allclose(e_qp[0], qp_ref, atol=5e-2)
    assert np.all(info["z"][0] > 0.5) and np.all(info["z"][0] <= 1.5)
    assert e_qp[0, 0] < mo_e[0]


def test_g0w0_ks_hf_reference_matches_krhf():
    """KRKS(xc='hf'): hyb = 1 and vxc = 0, so the static correction
    vanishes and the KS path reproduces G0W0@KRHF (both converged here)."""
    cell, kpts, df, _ = h2_state("h2_gamma")
    mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-11, device="cpu")
    mf.kernel()
    ks = KRKS(cell, kpts, df, xc="hf", verbose=0, conv_tol=1e-11,
              device="cpu")
    ks.kernel()
    assert mf.converged and ks.converged
    assert np.all(_static_correction(df, mf, [0, 1, 2, 3]) == 0.0)
    e_hf, _ = g0w0(df, mf, nw=NW)
    e_ks, info = g0w0(df, ks, nw=NW)
    assert np.abs(info["correction"]).max() < 1e-10
    np.testing.assert_allclose(e_ks, e_hf, atol=1e-5)


def test_bse_with_bare_w_is_cis():
    _, _, df, mf = h2_state("h2_k2")
    for q in (0, 1):
        a_cis = TDAOperator(mf, df, q=q, singlet=True).dense()
        a_bse = bse_mod.BSEOperator(mf, df, q=q, singlet=True,
                                    wqs=df.wq).dense()
        np.testing.assert_allclose(a_bse, a_cis, atol=1e-10)


def test_static_w_chi0_zero_limit():
    """Scissored gaps: chi0 ~ 1/delta, so W - w_q vanishes linearly in the
    inverse gap."""
    _, _, df, mf = h2_state("h2_gamma")
    wq = df.wq.numpy()
    scale = np.abs(wq).max()
    ds = []
    for shift in (1e6, 1e7):
        qp = mf.mo_energy.copy()
        qp[:, 1:] += shift
        wqs = bse_mod.static_w(df, mf, qp_energy=qp).numpy()
        ds.append(np.abs(wqs - wq).max())
    assert ds[0] < 1e-6 * scale
    assert ds[1] < 0.2 * ds[0]


def test_bse_dense_mo_space_oracle(gamma_oracle):
    """Dense construction in the MO pair space (H2: nocc 1, nvir 3):
    chi = chi0 (I - V chi0)^{-1}, chi0 = diag(-4/delta_p),
    W_{(ab),(ji)} = (ab|ji) + sum (ab|p) chi_pp' (p'|ji),
    A_{ia,jb} = delta + 2 (ai|jb) - W_{(ab),(ji)}."""
    _, _, df, mf, eri = gamma_oracle
    eri = eri.real
    e = mf.mo_energy[0]
    pairs = [(0, 1 + a) for a in range(3)]
    npair = len(pairs)
    delta_p = np.array([e[a] - e[i] for i, a in pairs])
    chi0 = np.diag(-4.0 / delta_p)
    vmat = np.array([[eri[i1, a1, i2, a2] for (i2, a2) in pairs]
                     for (i1, a1) in pairs])
    chi = chi0 @ np.linalg.inv(np.eye(npair) - vmat @ chi0)
    a_ref = np.zeros((npair, npair))
    for r, (i, a) in enumerate(pairs):
        for c, (j, b) in enumerate(pairs):
            w_abji = eri[a, b, j, i] + sum(
                eri[a, b, i1, a1] * chi[p1, p2] * eri[i2, a2, j, i]
                for p1, (i1, a1) in enumerate(pairs)
                for p2, (i2, a2) in enumerate(pairs))
            a_ref[r, c] = 2.0 * eri[a, i, j, b] - w_abji
            if r == c:
                a_ref[r, c] += delta_p[r]
    w_ref = np.sort(np.linalg.eigvalsh(0.5 * (a_ref + a_ref.T)))
    w, _ = bse_mod.bse(mf, df, q=0, nroots=0, dense=True)
    np.testing.assert_allclose(w, w_ref, atol=1e-7)


def test_bse_scissor_shifts_spectrum():
    _, _, df, mf = h2_state("h2_k2")
    op0 = bse_mod.BSEOperator(mf, df, q=1)
    qp = mf.mo_energy.copy()
    qp[:, 1:] += 0.1
    op1 = bse_mod.BSEOperator(mf, df, q=1, qp_energy=qp, wqs=op0.wqs)
    a0, a1 = op0.dense(), op1.dense()
    w0 = np.linalg.eigvalsh(0.5 * (a0 + a0.conj().T))
    w1 = np.linalg.eigvalsh(0.5 * (a1 + a1.conj().T))
    np.testing.assert_allclose(w1, w0 + 0.1, atol=1e-10)
