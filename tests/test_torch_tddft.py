"""The port's linear response (``scf.tddft``: TDA, UTDA, Casida TDDFT,
oscillator strengths, the dielectric function) against the JAX
package's, on the CPU in float64.

On the JAX package's interpolation points and converged orbitals
(tests/data/jax_port_refs.json, ``tools/jax_port_refs.py many_body``):
CIS singlet/triplet of the H2 chain at gamma and at both sectors of the
1x1x2 mesh, Davidson at q = 0 (tol 1e-8), UTDA of the spin-2 KUHF,
Casida TDHF; TDA with the PBE kernel (H2 gamma, diamond gth-szv ke 50
1x1x2 at q = 0 and q = 1), with B3LYP (exchange and kernel) and HSE06
(screened exchange) at q = 1, Casida with the PBE kernel (H2 gamma),
UTDA-PBE, the oscillator strengths and eps_M(q) on diamond: excitation
energies and eps_M at 1e-10 relative, Davidson roots at 1e-8.  The xc kernel's
Hessian-vector product on diamond's mesh (the toy density and the
zeta = +-1 tie) is held to the JAX package's jvp(grad(Exc)) for LDA, PBE,
B3LYP and HSE06 at 1e-10 relative; at s^2 = 0 (a uniform density, where
the JAX package's HSE06 potential is NaN) to a central difference of the
port's own vxc.  The port alone, with the JAX tests' gates: CIS against
a dense oracle from exact plane-wave MO ERIs (1e-8), KRKS(xc='hf') TDA
is CIS, UTDA of a closed shell is the union of the singlet and triplet
spectra, Davidson equals the dense route, the momentum-matrix identity in
a 0d box, the small-q density head and the f-sum on the 1x1x4 chain, and
meta-GGA raises as in the JAX package.
"""
import numpy as np
import pytest
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.pw import get_eri_from_ao
from fftisdf_tpu_torch.scf import KRHF, KRKS, KUHF, KUKS
from fftisdf_tpu_torch.scf import xc as xc_mod
from fftisdf_tpu_torch.scf.tddft import (TDAOperator, _hvp,
                                         density_fluctuation,
                                         dielectric_tda, momentum_matrix,
                                         oscillator_strengths, tda, tddft,
                                         utda)
from test_torch_mp2_rpa import (REFS, closed_shell_u, h2_cell, h2_state,
                                unpack, with_orbitals)


def relmax(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def diamond():
    """(cell, kpts, df, reference(xc)) on diamond 1x1x2: KRKS objects
    holding the JAX package's orbitals, on the JAX package's points."""
    rec = REFS["diamond"]
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build(mask=np.asarray(rec["mask"]))
    made = {}

    def reference(xc):
        if xc not in made:
            made[xc] = with_orbitals(KRKS(cell, kpts, df, xc=xc, verbose=0,
                                          device="cpu"), rec[xc])
        return made[xc]

    return cell, kpts, df, reference


H2_CASES = [("h2_gamma", 0, True, "tda_s"), ("h2_gamma", 0, False, "tda_t"),
            ("h2_k2", 0, True, "tda_s_q0"), ("h2_k2", 1, True, "tda_s_q1"),
            ("h2_k2", 1, False, "tda_t_q1")]


@pytest.mark.parametrize("key,q,singlet,name", H2_CASES)
def test_cis_matches_jax(key, q, singlet, name):
    _, _, df, mf = h2_state(key)
    w, info = tda(mf, df, q=q, singlet=singlet, nroots=0, dense=True)
    assert info["nonhermiticity"] < 1e-10
    assert relmax(w, REFS[key][name]) < 1e-10


@pytest.mark.parametrize("xc,q,singlet,name",
                         [("pbe", 0, True, "tda_s_q0"),
                          ("pbe", 0, False, "tda_t_q0"),
                          ("pbe", 1, True, "tda_s_q1"),
                          ("b3lyp", 1, True, "tda_s_q1"),
                          ("hse06", 1, True, "tda_s_q1")])
def test_ks_tda_matches_jax(diamond, xc, q, singlet, name):
    """The adiabatic kernel (real and imaginary tangents at q = 1), full
    and screened exact exchange, on diamond."""
    _, _, df, reference = diamond
    w, _ = tda(reference(xc), df, q=q, singlet=singlet, nroots=0,
               dense=True)
    assert relmax(w, REFS["diamond"][xc][name]) < 1e-10


def test_pbe_tda_h2_matches_jax():
    cell, kpts, df, _ = h2_state("h2_gamma")
    ks = with_orbitals(KRKS(cell, kpts, df, xc="pbe", verbose=0,
                            device="cpu"), REFS["h2_gamma"]["krks_pbe"])
    for singlet, name in ((True, "pbe_tda_s"), (False, "pbe_tda_t")):
        w, _ = tda(ks, df, singlet=singlet, nroots=0, dense=True)
        assert relmax(w, REFS["h2_gamma"][name]) < 1e-10
    assert relmax(tddft(ks, df, nroots=3)[0],
                  REFS["h2_gamma"]["pbe_tddft"]) < 1e-10


def test_davidson_matches_jax_and_dense():
    _, _, df, mf = h2_state("h2_k2")
    w, info = tda(mf, df, q=0, nroots=3, dense=False, tol=1e-8)
    assert info["converged"] and not info["dense"]
    assert relmax(w, REFS["h2_k2"]["tda_davidson_q0"]) < 1e-8
    w_dense, _ = tda(mf, df, q=0, nroots=3, dense=True)
    np.testing.assert_allclose(w, w_dense, atol=1e-8)


@pytest.mark.parametrize("key,q,name", [("h2_gamma", 0, "tddft"),
                                        ("h2_k2", 1, "tddft_q1")])
def test_casida_matches_jax(key, q, name):
    _, _, df, mf = h2_state(key)
    w, info = tddft(mf, df, q=q, nroots=3)
    assert np.all(w > 0)
    assert relmax(w, REFS[key][name]) < 1e-10
    if key == "h2_gamma":
        # TDHF lowers every TDA root here (tests/test_tddft.py)
        w_tda, _ = tda(mf, df, q=0, nroots=3, dense=True)
        assert np.all(w <= w_tda + 1e-10) and w[0] < w_tda[0] - 1e-4


def test_diamond_pbe_spectra_match_jax(diamond):
    """UTDA-PBE at q = 1 on the closed shell (the union of the singlet and
    triplet spectra), the oscillator strengths at q = 0 (summed over
    degenerate roots) and eps_M(q = 1).  (Casida with the PBE kernel is
    held on the H2 chain here and on diamond by chip_smoke.py phase 10a.)"""
    cell, kpts, df, reference = diamond
    ks = reference("pbe")
    rec = REFS["diamond"]["pbe"]
    u = KUKS(cell, kpts, df, xc="pbe", verbose=0, device="cpu")
    u.mo_coeff, u.mo_energy = (np.stack([ks.mo_coeff] * 2),
                               np.stack([ks.mo_energy] * 2))
    u.mo_occ = np.stack([ks.mo_occ] * 2) * 0.5
    u.dm = np.stack([ks.dm] * 2) * 0.5
    wu, _ = utda(u, df, q=1, nroots=0, dense=True)
    assert relmax(wu, rec["utda"]) < 1e-10
    # the singlet half is test_ks_tda_matches_jax[pbe-1-True-tda_s_q1]'s
    union = np.sort(np.concatenate([
        rec["tda_s_q1"],
        tda(ks, df, q=1, singlet=False, nroots=0, dense=True)[0]]))
    assert relmax(wu, union) < 1e-10
    w0, info = tda(ks, df, q=0, nroots=0, dense=True)
    f = oscillator_strengths(ks, w0, info["x"])
    groups = np.split(np.arange(len(w0)),
                      np.nonzero(np.diff(w0) > 1e-6)[0] + 1)
    got = [f[g].sum() for g in groups]
    want = [np.asarray(rec["osc"])[g].sum() for g in groups]
    np.testing.assert_allclose(got, want, rtol=1e-8,
                               atol=1e-10 * max(want))
    eps, d = dielectric_tda(ks, df, q=1, omegas=np.linspace(0.0, 2.0, 9))
    assert relmax(eps, unpack(rec["eps"])) < 1e-10
    assert eps[0].real > 1.0 and np.all(d["loss"] > -1e-12)


def test_utda_matches_jax_and_closed_shell_union():
    _, _, df, mf = h2_state("h2_k2")
    rec = REFS["h2_k2"]
    umf = with_orbitals(KUHF(h2_cell(spin=2), mf.kpts, df, verbose=0,
                             device="cpu"), rec["kuhf_spin2"])
    w, info = utda(umf, df, nroots=0, dense=True)
    assert info["nonhermiticity"] < 1e-10
    assert relmax(w, rec["utda_spin2"]) < 1e-10
    for q in (0, 1):
        wu, _ = utda(closed_shell_u(mf), df, q=q, nroots=0, dense=True)
        union = np.sort(np.concatenate([
            tda(mf, df, q=q, singlet=s, nroots=0, dense=True)[0]
            for s in (True, False)]))
        assert relmax(wu, union) < 1e-10


def _hvp_densities(fmesh):
    """tools/jax_port_refs.py::hvp_densities: the toy density and the
    zeta = +-1 tie of tests/test_torch_xc.py."""
    ng = int(np.prod(fmesh))

    def toy(seed):
        coef = np.random.default_rng(seed).standard_normal((2, 4, 4, 4))
        field = np.zeros((2,) + tuple(fmesh))
        for s in range(2):
            f = np.zeros(fmesh, dtype=complex)
            f[:4, :4, :4] = coef[s] * 0.05 * ng
            field[s] = np.real(np.fft.ifftn(f))
        return (0.3 + field - field.min()).reshape(2, ng)

    pol = toy(5)
    pol[1, : ng // 2] = 0.0
    pol[0, ng // 2:] = 0.0
    return {"toy": toy(1), "zeta=+-1": pol}


@pytest.fixture(scope="module")
def hvp_grid():
    fmesh = tuple(REFS["hvp"]["fmesh"])
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    assert tuple(int(m) for m in cell.mesh) == fmesh
    gv = torch.as_tensor(cell.get_Gv(fmesh))
    return fmesh, gv, float(cell.vol) / int(np.prod(fmesh))


@pytest.mark.parametrize("case", ["toy", "zeta=+-1"])
def test_hvp_matches_jax(hvp_grid, case):
    """The kernel's HVP (double backward of Exc) against the JAX package's
    jvp(grad(Exc)), read on the recorded probes."""
    fmesh, gv, weight = hvp_grid
    ng = int(np.prod(fmesh))
    rng = np.random.default_rng(17)
    tangents = torch.as_tensor(rng.standard_normal((2, 2, ng)))
    probes = rng.standard_normal((3, 2, ng))
    rho = torch.as_tensor(_hvp_densities(fmesh)[case])
    for name in ("lda", "pbe", "b3lyp", "hse06"):
        h = _hvp(rho, tangents, gv, xc_mod.parse_xc(name), fmesh,
                 weight).numpy()
        got = [[float(np.sum(p * ht)) for p in probes] for ht in h]
        assert relmax(got, REFS["hvp"][f"{case}/{name}"]) < 1e-10, name


@pytest.mark.parametrize("name,tangent", [("pbe", "random"),
                                          ("pbe", "uniform"),
                                          ("hse06", "uniform")])
def test_hvp_central_difference_at_uniform_density(hvp_grid, name,
                                                   tangent):
    """At s^2 = 0 the JAX package's HSE06 potential is NaN (ROADMAP §3), so
    the port's HVP there is held to a central difference of its own vxc
    (step 1e-5, relative to the HVP's scale).  The HJS exchange holds
    sqrt(s^2), which has a kink at s^2 = 0: along a tangent that makes the
    density non-uniform the difference quotient converges to a limit that
    is not linear in the tangent (25% off any HVP), so HSE06 is held along
    uniform tangents, where s^2 stays 0; PBE along both."""
    fmesh, gv, weight = hvp_grid
    ng = int(np.prod(fmesh))
    rho = torch.stack([torch.full((ng,), 0.21, dtype=torch.float64),
                       torch.full((ng,), 0.13, dtype=torch.float64)])
    if tangent == "random":
        t = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (2, ng)))
    else:
        t = torch.tensor([[0.7], [-0.4]], dtype=torch.float64).expand(2, ng)
    spec = xc_mod.parse_xc(name)
    h = _hvp(rho, t[None], gv, spec, fmesh, weight)[0]
    assert bool(torch.isfinite(h).all())
    eps = 1e-5
    vxc = lambda r: xc_mod.exc_and_vxc(r, gv, spec, fmesh, weight)[1]
    fd = (vxc(rho + eps * t) - vxc(rho - eps * t)) / (2 * eps) * weight
    assert float((h - fd).abs().max() / h.abs().max()) < 1e-6


def _dense_cis(eri, mo_e, nocc, singlet):
    """Molecular CIS from a dense chemists' MO ERI."""
    no, nv = nocc, eri.shape[0] - nocc
    a = np.zeros((no, nv, no, nv), dtype=complex)
    for i in range(no):
        for aa in range(nv):
            a[i, aa, i, aa] += mo_e[nocc + aa] - mo_e[i]
    o, v = slice(None, nocc), slice(nocc, None)
    if singlet:
        a += 2.0 * np.einsum("aijb->iajb", eri[v, o, o, v])
    a -= np.einsum("abji->iajb", eri[v, v, o, o])
    m = a.reshape(no * nv, no * nv)
    return np.sort(np.linalg.eigvalsh(0.5 * (m + m.conj().T)))


@pytest.mark.parametrize("singlet", [True, False])
def test_cis_matches_exact_oracle(singlet):
    cell, kpts, df, mf = h2_state("h2_gamma")
    coords = cell.gen_uniform_grids()
    ao = make_evaluator(cell, kpts=kpts, device="cpu")(coords)[0]
    mo = ao @ torch.as_tensor(mf.mo_coeff[0])
    eri = get_eri_from_ao(cell, (mo,) * 4, np.zeros(3), coords).numpy()
    w_ref = _dense_cis(eri, mf.mo_energy[0], 1, singlet)
    w, _ = tda(mf, df, q=0, singlet=singlet, nroots=0, dense=True)
    np.testing.assert_allclose(w, w_ref, atol=1e-8)


def test_ks_hf_reduces_to_cis_and_mgga_raises():
    cell, kpts, df, _ = h2_state("h2_gamma")
    mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10, device="cpu")
    mf.kernel()
    ks = KRKS(cell, kpts, df, xc="hf", verbose=0, conv_tol=1e-10,
              device="cpu")
    ks.kernel()
    np.testing.assert_allclose(tda(ks, df, nroots=3, dense=True)[0],
                               tda(mf, df, nroots=3, dense=True)[0],
                               atol=1e-7)
    scan = KRKS(cell, kpts, df, xc="scan", verbose=0, device="cpu")
    scan.mo_coeff, scan.mo_energy, scan.mo_occ = (mf.mo_coeff, mf.mo_energy,
                                                  mf.mo_occ)
    scan.dm = mf.dm
    with pytest.raises(NotImplementedError):
        tda(scan, df)


def test_momentum_matrix_local_potential_identity():
    """p_ia = (e_a - e_i) r_ia for a local potential (LDA, the
    projector-free H pseudo) in a 0d box, to the basis error (~9 %);
    the sigma -> sigma* root carries the oscillator strength."""
    cell = h2_cell()
    kpts = np.zeros((1, 3))
    df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                 trunc="0d", select_tol=1e-18, rcond=1e-12,
                 device="cpu").build()
    mf = KRKS(cell, kpts, df, xc="lda", trunc="0d", verbose=0,
              conv_tol=1e-11, device="cpu")
    mf.kernel()
    assert mf.converged
    p = momentum_matrix(mf).numpy()
    coords = cell.gen_uniform_grids()
    mo = (make_evaluator(cell, kpts=kpts, device="cpu")(coords)[0]
          @ torch.as_tensor(mf.mo_coeff[0])).numpy()
    w = cell.vol / coords.shape[0]
    e = mf.mo_energy[0]
    r0 = coords.mean(axis=0)
    r_ia = np.stack([w * np.einsum("g,gi,ga->ia", coords[:, d] - r0[d],
                                   mo[:, :1].conj(), mo[:, 1:])
                     for d in range(3)])
    de = e[None, 1:] - e[:1, None]
    assert np.abs(p[:, 0] - de[None] * r_ia).max() < 0.10 * np.abs(p).max()
    wtda, info = tda(mf, df, q=0, nroots=3, dense=True)
    f = oscillator_strengths(mf, wtda, info["x"])
    assert np.all(f >= 0)
    assert f[0] > 0.1 and f[0] > 100 * f[1]


def test_density_fluctuation_small_q_and_f_sum():
    """On the 1x1x4 chain (KRKS-LDA): the density head obeys the small-q
    dipole limit |rho_q| ~ |q.p|/de and the independent-particle f-sum
    2 sum de |rho_q|^2 = |q|^2 N_sc / 2 holds to the basis error."""
    cell = h2_cell()
    kpts = cell.get_kpts([1, 1, 4])
    df = FFTISDF(cell, kpts, c0=60.0, m0=(11, 11, 13), verbose=0,
                 select_tol=1e-18, rcond=1e-12, device="cpu").build()
    mf = KRKS(cell, kpts, df, xc="lda", verbose=0, conv_tol=1e-10,
              device="cpu")
    mf.kernel()
    assert mf.converged
    op = TDAOperator(mf, df, q=1)
    rho = density_fluctuation(mf, op).numpy()
    p = momentum_matrix(mf).numpy()
    qvec = kpts[1] - kpts[0]
    approx = np.einsum("d,dkia->kia", qvec, p) / op.delta
    sel = np.abs(rho).ravel() > 0.3 * np.abs(rho).max()
    ratio = (np.abs(rho).ravel() / np.abs(approx).ravel())[sel]
    assert np.all((ratio > 0.85) & (ratio < 1.15))
    ipsum = 2.0 * float(np.sum(op.delta * np.abs(rho) ** 2))
    trk = 0.5 * np.linalg.norm(qvec) ** 2 * cell.nelectron * len(kpts)
    assert 0.85 < ipsum / trk < 1.15
