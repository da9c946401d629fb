"""The port's k-point CC layer (``scf.cc``) against the JAX package's and
against the determinant-space oracle of tests/test_cc.py, on the CPU.

- The oracle of tests/test_cc.py (Jordan-Wigner operators on the Fock
  space, e^T as a finite series; numpy only, tests/cc_oracle.py) holds the step, the
  full-fock residual and (T) at random complex amplitudes and integrals
  (1e-10), and EOM-EE, EOM-IP/EA and both Lambda densities at converged
  random systems (1e-9), the JAX tests' gates.
- The packed residual equals the per-block reference (1e-12) and the JAX
  package's packed residual on the JAX test's seeded inputs (1e-12,
  recorded); the structured amplitude basis equals the dense one and the
  JAX package's; the on-device amplitude DIIS equals the host DIIS.
- On the H2 chain of tests/test_cc.py (gamma and 1x1x2) and diamond
  gth-szv ke 50 1x1x2 the port runs on the JAX package's interpolation
  points and real-gauge orbitals (tests/data/jax_port_refs.json,
  ``many_body`` and ``correlated``, written by
  ``tools/jax_port_refs.py``): kccsd, kccsd_t, the EOM drivers and the
  densities are held to the JAX package's values (energies 1e-8 relative,
  EOM and densities 1e-9, the Davidson roots 1e-6 as the JAX test holds
  them to the dense ones); the physical identities hold as in the JAX
  tests (CCSD = FCI for two electrons, the first iterate = kmp2 / kump2,
  closed-shell KUHF = KRHF, the KS-reference invariance).
"""
import json
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.scf import KRKS, KUHF
from fftisdf_tpu_torch.scf import cc
from fftisdf_tpu_torch.scf.mp2 import kmp2, kump2
from cc_oracle import (Oracle, _random_amps, _random_u, densities,
                       eom_spectra, hbar, left_state, t3_energy)
from test_torch_mp2_rpa import (ISDF_KW, closed_shell_u, h2_cell, h2_state,
                                rel, unpack, with_orbitals)

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS.parent / "tools"))
import jax_port_refs as tool  # noqa: E402  (numpy only at import)

DATA = json.loads((TESTS / "data" / "jax_port_refs.json").read_text())
REFS = DATA["correlated"]
t = torch.as_tensor


def cplx(pairs):
    """[[re, im], ...] of the record -> complex array."""
    a = np.asarray(pairs)
    return a[..., 0] + 1j * a[..., 1]


def with_energy(mf):
    """``mf`` given e_tot at its density (the recorded orbitals carry
    none)."""
    _, vj, vk = mf.get_fock(mf.dm)
    mf.e_tot = mf.energy_elec(mf.dm, vj, vk) + mf.e_nuc
    return mf


@lru_cache(maxsize=None)
def state(key):
    """(df, KRHF) on the JAX package's points and orbitals: the H2 chain
    (``h2_gamma``, ``h2_k2``) or diamond szv 1x1x2."""
    from fftisdf_tpu_torch.scf import KRHF

    if key != "diamond":
        _, _, df, mf = h2_state(key)
        return df, with_energy(mf)
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build(mask=np.asarray(REFS[key]["mask"]))
    mf = with_orbitals(KRHF(cell, kpts, df, verbose=0, device="cpu"),
                       REFS[key]["krhf"])
    return df, with_energy(mf)


@lru_cache(maxsize=None)
def amps(key, conv_tol):
    df, mf = state(key)
    return cc.kccsd(df, mf, conv_tol=conv_tol, max_cycle=80,
                    return_amps=True)


def first_iterate(df, mf):
    """The correlation energy a step reports at the MP2 guess."""
    U, eo, ev, nocc = cc.make_eris_dev(df, mf)
    nk = df.nkpt
    kp3 = cc._kp3(df)
    U = U / nk
    t1 = torch.zeros((nk, nocc, ev.shape[1]), dtype=U.dtype)
    t2 = cc._mp2_guess(U, nocc, eo, ev, kp3)
    e = cc.make_step(nk, nocc, ev.shape[1], kp3, eo, ev)(t1, t2, U)[2]
    return complex(e) / nk


# ----------------------------------------------------------------------
# random inputs: the packed residual, the oracle
# ----------------------------------------------------------------------

def test_packed_equations_match_reference_and_jax():
    """Packed residual = per-block reference = the JAX package's packed
    residual on the JAX test's seeded inputs (random U, amplitudes and a
    full complex fock, nk 2)."""
    t1, t2, f, U, kp3 = tool.packed_inputs()
    args = (t(t1), t(t2), tuple(t(x) for x in f), t(U))
    r1a, r2a, ea = cc._equations(2, 2, 2, kp3)(*args)
    r1b, r2b, eb = cc._equations_packed(2, 2, 2, kp3)(*args)
    assert abs(complex(ea - eb)) < 1e-12
    assert float((r1a - r1b).abs().max()) < 1e-12
    assert float((r2a - r2b).abs().max()) < 1e-12
    rec = REFS["packed"]
    assert abs(complex(eb) - complex(*rec["e"])) < 1e-12
    assert np.abs(r1b.numpy() - unpack(rec["r1"])).max() < 1e-12
    assert np.abs(r2b.numpy().reshape(-1) - unpack(rec["r2"]).reshape(-1)
                  ).max() < 1e-12


def test_residual_full_fock_matches_oracle():
    """The per-block residual with a full Hermitian one-body matrix (the
    bare-f terms and the T1 driving f[a,i]) against the literal one."""
    rng = np.random.default_rng(23)
    no, nv = 2, 3
    n = no + nv
    u = 0.2 * _random_u(n, rng)
    e = np.concatenate([-1.0 - rng.random(no), 1.0 + rng.random(nv)])
    df_ = 0.3 * (rng.standard_normal((n, n))
                 + 1j * rng.standard_normal((n, n)))
    fock = np.diag(e) + df_ + df_.conj().T
    t1, t2 = _random_amps(no, nv, rng)
    r1_o, r2_o, e_o = Oracle(u, e, no, fock=fock).residuals(t1, t2)
    f = tuple(t(x)[None] for x in (fock[:no, :no], fock[:no, no:],
                                   fock[no:, :no], fock[no:, no:]))
    kp3 = np.zeros((1, 1, 1), dtype=np.int64)
    for eqs in (cc._equations, cc._equations_packed):
        r1, r2, e_t = eqs(1, no, nv, kp3)(t(t1)[None], t(t2)[None, None, None],
                                          f, t(u)[None, None, None])
        assert abs(complex(e_t) - e_o) < 1e-10
        assert np.abs(r1[0].numpy() - r1_o).max() < 1e-10
        assert np.abs(r2[0, 0, 0].numpy() - r2_o).max() < 1e-10


def test_step_and_t3_match_determinant_oracle():
    """The CCSD step (every term and conjugation) and the (T) energy
    against the literal <Phi_ex| e^-T H e^T |0> and
    <0|(T1+T2)^dag H T3c|0> at random amplitudes and integrals."""
    kp3 = np.zeros((1, 1, 1), dtype=np.int64)
    rng = np.random.default_rng(7)
    no, nv = 2, 3
    n = no + nv
    u = 0.2 * _random_u(n, rng)
    e = np.concatenate([-1.0 - rng.random(no), 1.0 + rng.random(nv)])
    t1, t2 = _random_amps(no, nv, rng)
    r1_o, r2_o, e_o = Oracle(u, e, no).residuals(t1, t2)
    step = cc.make_step(1, no, nv, kp3, e[None, :no], e[None, no:])
    t1n, t2n, e_t = step(t(t1)[None], t(t2)[None, None, None],
                         t(u)[None, None, None])
    d1 = e[:no, None] - e[None, no:]
    d2 = (e[:no, None, None, None] + e[None, :no, None, None]
          - e[None, None, no:, None] - e[None, None, None, no:])
    assert abs(complex(e_t) - e_o) < 1e-10
    assert np.abs(d1 * (t1n[0].numpy() - t1) - r1_o).max() < 1e-10
    assert np.abs(d2 * (t2n[0, 0, 0].numpy() - t2) - r2_o).max() < 1e-10

    rng = np.random.default_rng(11)
    no, nv = 3, 3
    u = 0.2 * _random_u(no + nv, rng)
    e = np.concatenate([-1.0 - rng.random(no), 1.0 + rng.random(nv)])
    t1, t2 = _random_amps(no, nv, rng)
    e_ref = t3_energy(Oracle(u, e, no), e, t1, t2)
    fn = cc.make_t3_energy(1, no, nv, kp3, e[None, :no], e[None, no:],
                           chunk=1)
    e_t = complex(fn(t(t1)[None], t(t2)[None, None, None],
                     t(u)[None, None, None]))
    assert abs(e_t - e_ref) < 1e-10


def _converge_random(no, nv, u, e, tol=1e-13):
    """Converged amplitudes of a random system (Jacobi from the MP2
    guess, as tests/test_cc.py converges them)."""
    kp3 = np.zeros((1, 1, 1), dtype=np.int64)
    step = cc.make_step(1, no, nv, kp3, e[None, :no], e[None, no:])
    U = t(u)[None, None, None]
    t1 = torch.zeros((1, no, nv), dtype=torch.complex128)
    t2 = cc._mp2_guess(U, no, e[None, :no], e[None, no:], kp3)
    for _ in range(400):
        t1n, t2n, _ = step(t1, t2, U)
        dt = max(float((t1n - t1).abs().max()), float((t2n - t2).abs().max()))
        t1, t2 = t1n, t2n
        if dt < tol:
            break
    assert dt < tol
    return t1, t2, U, kp3


def _random_system(seed, no=2, nv=3):
    rng = np.random.default_rng(seed)
    u = 0.1 * _random_u(no + nv, rng)
    e = np.concatenate([-1.0 - rng.random(no), 1.0 + rng.random(nv)])
    return u, e


def test_eom_matches_determinant_oracle():
    """EOM-EE (dense Jacobian) and EOM-IP/EA (phantom orbital) against the
    literal Hbar projected on the singles+doubles, (N-1) and (N+1)
    determinant spaces; the Davidson roots against the dense ones."""
    no, nv = 2, 3
    u, e = _random_system(13)
    t1, t2, U, kp3 = _converge_random(no, nv, u, e)
    oracle = Oracle(u, e, no)
    want = eom_spectra(oracle, hbar(oracle, t1[0].numpy(),
                                    t2[0, 0, 0].numpy())[2])
    w = cc.eom_dense(1, no, nv, kp3, e[None, :no], e[None, no:], t1, t2, U)
    assert len(w) == len(want["ee"]) and np.abs(w - want["ee"]).max() < 1e-9
    # the matrix-free path on the same Jacobian
    _, matvec, dvec = cc._residual_fn(1, no, nv, kp3, e[None, :no],
                                      e[None, no:], U)
    basis = cc.AmpBasis(1, no, nv, kp3, "cpu")
    tvec = cc._pack(t1, t2, 1)
    w_dav, conv = cc.eom_davidson(lambda x: matvec(tvec, x), basis,
                                  -basis.diag_of(dvec), nroots=3, tol=1e-9)
    assert conv and np.abs(w_dav - w[:3]).max() < 1e-8
    for sector in ("ip", "ea"):
        w = cc.eom_qp(1, no, nv, kp3, e[None, :no], e[None, no:],
                      t1.numpy(), t2.numpy(), u[None, None, None], sector,
                      device="cpu")[0]
        assert len(w) == len(want[sector])
        assert np.abs(w - want[sector]).max() < 1e-9, sector


@pytest.mark.parametrize("no,nv", [(2, 3), (3, 2)])
def test_densities_match_determinant_oracle(no, nv):
    """lambda_rdm and lambda_rdm2 (adjoint solve, reverse-mode densities,
    the analytic driving part) against the literal <(1+Lambda) e^-T p+ q
    e^T> and <(1+Lambda) e^-T p+ q+ s r e^T>; the energy rebuilt from
    both.  (3, 2) has 3 electrons: the non-Hermitian parts of the
    unrelaxed density."""
    u, e = _random_system(29 if (no, nv) == (2, 3) else 37, no, nv)
    t1, t2, U, kp3 = _converge_random(no, nv, u, e)
    eo, ev = e[None, :no], e[None, no:]
    gam1, lam = cc.lambda_rdm(1, no, nv, kp3, eo, ev, t1, t2, U)
    gam2 = cc.lambda_rdm2(1, no, nv, kp3, eo, ev, t1, t2, U, lam=lam,
                          gam1=gam1)[0, 0, 0]
    oracle = Oracle(u, e, no)
    expT, expmT, hb = hbar(oracle, t1[0].numpy(), t2[0, 0, 0].numpy())
    left = left_state(oracle, hb, cc._amp_basis(1, no, nv, kp3)[1])
    g1_o, g2_o = densities(oracle, expT, expmT, left)
    g1 = np.block([[gam1[0][0], gam1[1][0]], [gam1[2][0], gam1[3][0]]])
    assert np.abs(g1 - g1_o).max() < 1e-9
    assert abs(np.trace(g1).real - no) < 1e-9
    assert np.abs(gam2 - g2_o).max() < 1e-9
    h1 = np.diag(e).astype(complex) - np.einsum("piqi->pq",
                                                u[:, :no, :, :no])
    e_rdm = (np.einsum("pq,pq->", h1, g1)
             + 0.25 * np.einsum("pqrs,pqrs->", u, gam2))
    e_corr = complex(cc.make_step(1, no, nv, kp3, eo, ev)(t1, t2, U)[2])
    assert abs(e_rdm - oracle.e_ref - e_corr) < 1e-9


def test_amp_basis_and_diis():
    """The structured basis is the dense basis (and the JAX package's):
    same columns, B c and B^T y, the preconditioner diagonal; the
    on-device amplitude DIIS extrapolates as the host DIIS does, past a
    full ring."""
    from fftisdf_tpu.scf import cc as jax_cc
    from fftisdf_tpu_torch.scf.hf import DIIS

    kp3 = np.array([[[0, 1], [1, 0]], [[1, 0], [0, 1]]])
    labels, dense = cc._amp_basis(2, 2, 3, kp3)
    labels_j, dense_j = jax_cc._amp_basis(2, 2, 3, kp3)
    basis = cc.AmpBasis(2, 2, 3, kp3, "cpu")
    assert labels == labels_j and np.array_equal(dense, dense_j)
    assert np.array_equal(basis.dense().numpy(), dense)
    rng = np.random.default_rng(5)
    c = rng.standard_normal((basis.shape[1], 3)) + 0j
    y = rng.standard_normal((basis.shape[0], 3)) + 1j
    assert np.abs(basis.apply(t(c)).numpy() - dense @ c).max() < 1e-14
    assert np.abs(basis.adjoint(t(y)).numpy() - dense.T @ y).max() < 1e-14
    d = rng.standard_normal(basis.shape[0])
    assert np.abs(basis.diag_of(d) - np.diag(dense.T @ (d[:, None] * dense))
                  ).max() < 1e-14

    host, dev = DIIS(space=4), None
    for it in range(7):
        v = rng.standard_normal(50) + 1j * rng.standard_normal(50)
        err = (rng.standard_normal(50) + 1j * rng.standard_normal(50)) \
            * 0.5 ** it
        if dev is None:
            dev = cc.AmplitudeDIIS(4, t(v))
        a = dev.update(t(v), t(err)).numpy()
        b = host.update(v, err)
        assert np.abs(a - b).max() < 1e-12 * np.abs(b).max(), it


def test_dev_mesh_raises():
    """The mesh is the port's DeviceMesh (tests/test_torch_parallel.py
    runs it); anything else is refused."""
    df, mf = state("h2_gamma")
    with pytest.raises(TypeError, match="DeviceMesh"):
        cc.kccsd(df, mf, dev_mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        cc._equations_packed(1, 1, 1, np.zeros((1, 1, 1), int), mesh=object())


# ----------------------------------------------------------------------
# the ISDF fixtures against the JAX package
# ----------------------------------------------------------------------

def test_h2_gamma_matches_jax_and_fci():
    """Gamma, 2 electrons: the JAX package's CCSD energy, EOM-EE spectrum,
    Davidson roots and EOM-IP/EA quasiparticle energies; (T) vanishes;
    the integral blocks carry the exact antisymmetries.  (CCSD = FCI for
    two electrons: test_torch_fci_dmet.py::test_dmet_identities.)"""
    rec = REFS["h2_gamma"]
    df, mf = state("h2_gamma")
    e_cc, info = amps("h2_gamma", 1e-10)
    assert info["converged"] and abs(info["imag"]) < 1e-9
    assert e_cc < 0 and rel(e_cc, rec["kccsd"]["e"]) < 1e-8, \
        (e_cc, rec["kccsd"]["e"])
    U, eo, ev, nocc = cc.make_eris(df, mf)
    u = U[0, 0, 0]
    assert np.abs(u + u.transpose(1, 0, 2, 3)).max() < 1e-14
    assert np.abs(u + u.transpose(0, 1, 3, 2)).max() < 1e-14
    assert np.abs(np.concatenate([eo[0], ev[0]])
                  - np.repeat(mf.mo_energy[0], 2)[[0, 1, 2, 4, 6, 3, 5, 7]]
                  ).max() == 0.0
    assert cc.kccsd_t(df, mf, conv_tol=1e-9)[1] == 0.0

    args = (1, nocc, ev.shape[1], info["kp3"], info["eo"], info["ev"],
            info["t1"], info["t2"], info["U"])
    w = cc.eom_dense(*args)
    assert np.abs(w - cplx(rec["eomee"])).max() < 1e-9
    w_dav, dav = cc.eomee_davidson(df, mf, nroots=4, conv_tol=1e-10,
                                   tol=1e-8)
    assert dav["eom_converged"]
    assert np.abs(w_dav - w[:4]).max() < 1e-6
    assert np.abs(w_dav - cplx(rec["eomee_davidson"])).max() < 1e-6
    for name, fn in (("eomip", cc.eomip), ("eomea", cc.eomea)):
        got, _ = fn(df, mf, conv_tol=1e-10)
        assert np.abs(got[0] - cplx(rec[name][0])).max() < 1e-9, name


def test_h2_k2_matches_jax():
    """1x1x2: CCSD and (T) energies, the first iterate = kmp2, and the
    one-particle densities (spin-orbital MO blocks and AO) of the JAX
    package."""
    rec = REFS["h2_k2"]
    df, mf = state("h2_k2")
    e_cc, e_t, info = cc.kccsd_t(df, mf, conv_tol=1e-9, max_cycle=80)
    assert info["converged"] and abs(info["imag_t"]) < 1e-9
    assert rel(e_cc, rec["kccsd_t"]["e_ccsd"]) < 1e-8
    assert e_t < 0 and rel(e_t, rec["kccsd_t"]["e_t"]) < 1e-8, \
        (e_t, rec["kccsd_t"]["e_t"])
    e1 = first_iterate(df, mf)
    assert abs(e1.imag) < 1e-10 and rel(e1.real, kmp2(df, mf)[0]) < 1e-10
    gam, oinfo = cc.onerdm(df, mf, conv_tol=1e-9)
    assert abs(oinfo["trace"] - rec["onerdm_trace"]) < 1e-9
    for name, blk in zip(("goo", "gov", "gvo", "gvv"), gam):
        assert np.abs(np.stack(blk) - unpack(rec["onerdm"][name])
                      ).max() < 1e-9, name
    dm, _ = cc.ao_density(df, mf, conv_tol=1e-9)
    assert np.abs(dm - unpack(rec["ao_density"])).max() < 1e-9
    nelec = np.einsum("skmn,knm->", dm, mf.s1e).real / 2
    assert abs(nelec - 2.0) < 1e-8


def test_reference_invariances():
    """Closed-shell KUHF = KRHF; the KS-reference invariance (2 electrons:
    E_det(KS determinant) + E_corr = E_HF + E_corr(HF)) with the JAX
    package's energy on the PBE reference; the spin-2 KUHF: first iterate
    = kump2 and the JAX package's CCSD energy."""
    rec = REFS["h2_gamma"]
    df, mf = state("h2_gamma")
    e_r, _ = amps("h2_gamma", 1e-10)
    e_u, info = cc.kccsd(df, closed_shell_u(mf), conv_tol=1e-10,
                         max_cycle=80)
    assert info["converged"] and abs(e_u - e_r) < 1e-9
    ks = with_orbitals(KRKS(mf.cell, mf.kpts, df, xc="pbe", verbose=0,
                            device="cpu"), DATA["many_body"]["h2_gamma"]
                       ["krks_pbe"])
    e_ks, info = cc.kccsd(df, ks, conv_tol=1e-10, max_cycle=120)
    assert info["converged"] and info["reference"] == "fock"
    ref = rec["kccsd_pbe_ref"]
    assert rel(e_ks, ref["e"]) < 1e-8, (e_ks, ref["e"])
    _, vj, vk = mf.get_fock(ks.dm)
    e_det = mf.energy_elec(ks.dm, vj, vk) + mf.e_nuc
    assert abs(e_det - ref["e_det"]) < 1e-8
    assert e_det > mf.e_tot + e_r
    assert abs(e_det + e_ks - (mf.e_tot + e_r)) < 3e-6

    df, mf = state("h2_k2")
    um = with_orbitals(KUHF(h2_cell(spin=2), mf.kpts, df, verbose=0,
                            device="cpu"), DATA["many_body"]["h2_k2"]
                       ["kuhf_spin2"])
    e1 = first_iterate(df, um)
    assert rel(e1.real, kump2(df, um)[0]) < 1e-10
    e_cc, info = cc.kccsd(df, um, conv_tol=1e-8, max_cycle=80)
    assert info["converged"] and e_cc < 0
    assert rel(e_cc, REFS["h2_k2"]["kccsd_spin2"]) < 1e-8


def test_diamond_matches_jax():
    """Diamond szv 1x1x2 (8 electrons a cell, 16 spin orbitals): the first
    iterate = kmp2, and the JAX package's CCSD and (T) energies, converged
    at the recorded conv_tol in the JAX package's number of cycles."""
    rec = REFS["diamond"]
    df, mf = state("diamond")
    e1 = first_iterate(df, mf)
    assert rel(e1.real, kmp2(df, mf)[0]) < 1e-10
    e_cc, e_t, info = cc.kccsd_t(df, mf, conv_tol=tool.CC_TOL["diamond"],
                                 max_cycle=80)
    assert info["converged"] and info["niter"] == rec["kccsd"]["niter"]
    assert abs(info["imag_t"]) < 1e-9
    assert rel(e_cc, rec["kccsd_t"]["e_ccsd"]) < 1e-8, \
        (e_cc, rec["kccsd_t"]["e_ccsd"])
    assert rel(e_t, rec["kccsd_t"]["e_t"]) < 1e-8, (e_t, rec["kccsd_t"]["e_t"])


# ----------------------------------------------------------------------
# the JAX tests' supercell gates (slow): the port alone, on its own SCF
# ----------------------------------------------------------------------

def _own_state(nz, kmesh, m0):
    """The port's own KRHF and build on the H2 chain (nz cells along z)."""
    from fftisdf_tpu_torch.scf import KRHF

    cell = h2_cell(nz=nz)
    kpts = cell.get_kpts(kmesh)
    df = FFTISDF(cell, kpts, **dict(ISDF_KW, m0=m0)).build()
    mf = KRHF(cell, kpts, df, verbose=0, conv_tol=1e-10, device="cpu")
    mf.kernel()
    assert mf.converged
    return df, mf


@pytest.mark.slow
def test_supercell_consistency():
    """tests/test_cc.py's supercell gates on the port: CCSD(T) per cell
    of the 1x1x2 k-mesh = the doubled supercell's at gamma / 2 (2e-5),
    the k-mesh's q = 0 EOM-EE energies and every EOM-IP energy within the
    supercell's spectrum (1e-4: two independent fits), the lowest IP near
    Koopmans (0.1 Ha)."""
    df1, mf1 = _own_state(1, [1, 1, 2], (11, 11, 13))
    df2, mf2 = _own_state(2, [1, 1, 1], (11, 11, 25))
    e_k, et_k, info_k = cc.kccsd_t(df1, mf1, conv_tol=1e-9, max_cycle=80)
    e_s, et_s, info_s = cc.kccsd_t(df2, mf2, conv_tol=1e-9, max_cycle=80)
    assert info_k["converged"] and info_s["converged"]
    assert abs(info_k["imag_t"]) < 1e-9 and et_s != 0.0
    assert abs(e_k - e_s / 2) < 2e-5 and abs(et_k - et_s / 2) < 2e-5
    w_k, _ = cc.eomee(df1, mf1, conv_tol=1e-9)
    w_s, _ = cc.eomee(df2, mf2, conv_tol=1e-9)
    assert np.max(np.abs(w_k.imag)) < 1e-6 and np.min(w_k.real) > 0
    assert all(np.min(np.abs(w_s - w)) < 1e-4 for w in w_k)
    ip_k, _ = cc.eomip(df1, mf1, conv_tol=1e-9)
    ip_s, _ = cc.eomip(df2, mf2, conv_tol=1e-9)
    all_k = np.concatenate([ip_k[k] for k in ip_k])
    assert np.max(np.abs(all_k.imag)) < 1e-6
    assert all(np.min(np.abs(ip_s[0] - w)) < 1e-4 for w in all_k)
    e_homo = max(float(mf1.mo_energy[k][0]) for k in range(2))
    assert 0 < np.min(all_k.real) and abs(np.min(all_k.real) + e_homo) < 0.1
