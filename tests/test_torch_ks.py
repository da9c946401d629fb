"""The port's Kohn-Sham drivers (``scf.ks``) against the JAX package's, and
their device-resident loops against their host loops (CPU, float64).

Diamond gth-szv ke 50, kmesh 1x1x2, on an ISDF build (c0 40, m0 9^3) given
the JAX package's interpolation points: KRKS-LDA/PBE/B3LYP/SCAN/HSE06 and
KUKS-LDA+U against the JAX package's converged energies (1e-8 Ha),
recorded in tests/data/jax_port_refs.json by ``tools/jax_port_refs.py ks``
(the same cell, build and settings).  Then, the port on its own: the
device-resident loop against the host loop on the same build for PBE
(DeviceKRKS, which must never fetch the image-space metric), PBE0
(DeviceKUKS), HSE06 (DeviceKRKS, the screened metric only) and LDA+U
(DeviceKUKS), 3e-8 Ha, the gate of tests/test_ks.py; closed-shell KUKS ==
KRKS; KRKS(xc='hf') == KRHF; band energies at a SCF mesh point equal
to the converged eigenvalues (5e-5, tests/test_ks.py's gate) for SCAN
and LDA+U, and their band-point Vxc and V_U matrices equal to the SCF's
(1e-10 relative); and the SCAN Fock matrix, tau term included, as the exact
derivative of Exc with respect to the density matrix.
"""
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.scf import (KRKS, KUKS, DeviceKRKS, DeviceKUKS,
                                   integrals, xc as xc_mod)
from torch_test_threads import two_torch_threads  # noqa: F401

REFS_HF = json.loads((Path(__file__).resolve().parent / "data"
                      / "jax_port_refs.json").read_text())
REFS = REFS_HF["ks_diamond"]
HUB = {0: (1, 0.2), 1: (1, 0.2)}
RUNS = {"krks_lda": (KRKS, "lda", None), "krks_pbe": (KRKS, "pbe", None),
        "krks_b3lyp": (KRKS, "b3lyp", None),
        "krks_scan": (KRKS, "scan", None),
        "krks_hse06": (KRKS, "hse06", None),
        "kuks_lda_u": (KUKS, "lda", HUB)}
KW = dict(verbose=0, conv_tol=1e-10, max_cycle=80, device="cpu")


@pytest.fixture(scope="module")
def diamond():
    """(cell, kpts, df, converged(key)): the port's build on the JAX
    package's points, and the host SCF of each key of RUNS, run once."""
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=40.0, m0=(9, 9, 9), verbose=0,
                 device="cpu").build(mask=np.asarray(REFS["mask"]))

    @lru_cache(maxsize=None)
    def converged(key):
        cls, xc, hub = RUNS[key]
        mf = cls(cell, kpts, df, xc=xc, hubbard=hub, **KW)
        mf.kernel()
        assert mf.converged, key
        return mf

    return cell, kpts, df, converged


@pytest.mark.parametrize("key", list(RUNS))
def test_ks_scf_matches_jax(diamond, key):
    mf = diamond[3](key)
    assert abs(mf.e_tot - REFS[key]["e_tot"]) < 1e-8, (mf.e_tot,
                                                       REFS[key]["e_tot"])
    if RUNS[key][2] is not None:
        assert mf._eu_last > 0.0          # the Dudarev penalty is positive


@pytest.mark.parametrize("case", ["pbe", "pbe0", "hse06", "lda+u"])
def test_device_ks_matches_host(diamond, monkeypatch, case):
    cell, kpts, df, converged = diamond
    if case == "pbe":
        host = converged("krks_pbe")
        # a pure functional never reads the image-space metric
        monkeypatch.setattr(df, "get_ws", lambda: pytest.fail("fetched ws"))
        dev = DeviceKRKS(cell, kpts, df, xc="pbe", **KW)
    elif case == "pbe0":
        host = KUKS(cell, kpts, df, xc="pbe0", **KW)
        host.kernel()
        dev = DeviceKUKS(cell, kpts, df, xc="pbe0", **KW)
    elif case == "hse06":
        host = converged("krks_hse06")
        # a screened hybrid reads its own erfc metric, never the full one
        monkeypatch.setattr(df, "get_ws", lambda: pytest.fail("fetched ws"))
        dev = DeviceKRKS(cell, kpts, df, xc="hse06", **KW)
    else:
        host = converged("kuks_lda_u")
        dev = DeviceKUKS(cell, kpts, df, xc="lda", hubbard=HUB, **KW)
    e = dev.kernel()
    assert host.converged and dev.converged
    assert abs(e - host.e_tot) < 3e-8, (e, host.e_tot)
    assert dev.dm.shape == host.dm.shape
    if case == "lda+u":
        assert dev._eu_last > 0.0


def test_kuks_closed_shell_and_hf_reduction(diamond):
    """Closed-shell KUKS == KRKS; KRKS(xc='hf') == KRHF on the same points
    (the KRHF energy of tests/test_torch_scf_device.py's record, which the
    port's KRHF meets to 3e-8 there)."""
    cell, kpts, df, converged = diamond
    mf_u = KUKS(cell, kpts, df, xc="lda", **KW)
    mf_u.kernel()
    assert mf_u.converged
    assert abs(mf_u.e_tot - converged("krks_lda").e_tot) < 1e-8
    ref = REFS_HF["scf_device_diamond"]
    assert ref["mask"] == REFS["mask"]
    mf = KRKS(cell, kpts, df, xc="hf", **KW)
    assert abs(mf.kernel() - ref["e_krhf"]) < 1e-8


@pytest.mark.parametrize("key", ["krks_scan", "kuks_lda_u"])
def test_bands_at_mesh_points_reproduce_scf(diamond, key):
    mf = diamond[3](key)
    es, _ = mf.get_bands(mf.kpts[1:])
    es, ref = np.asarray(es), np.asarray(mf.mo_energy)[..., 1:, :]
    nocc = diamond[0].nelectron // 2
    assert np.abs(es[..., :nocc + 1] - ref[..., :nocc + 1]).max() < 5e-5


@pytest.mark.parametrize("key", ["krks_scan", "kuks_lda_u"])
def test_band_point_potentials_match_scf(diamond, key):
    """At mesh points the band path's Vxc (the mesh density's potential
    against the band-point AOs, tau term included for SCAN) and V_U (the
    mesh occupations through the band-point S^1/2) are the SCF's own
    matrices to rounding: the eigenvalue gate above also holds the J
    re-fit's compression, these hold the band path's xc and +U alone."""
    cell, _, _, converged = diamond
    mf = converged(key)
    kb = mf.kpts[1:]
    # the band path's AOs and overlap (KRHF._band_ingredients' own calls)
    aob = make_evaluator(cell, kpts=kb, dtype=mf.dtype,
                         device=mf.device)(cell.gen_uniform_grids())
    s1e_b = integrals.get_ovlp(cell, aob).numpy()
    dm_s = mf.dm if mf.dm.ndim == 4 else np.stack([mf.dm, mf.dm]) * 0.5
    nspin = 2 if mf.dm.ndim == 4 else 1
    dm_dev = mf._dm_device(mf.dm if nspin == 2 else mf.dm[None])
    v_b = mf._band_vxc(dm_dev, aob, nspin, kpts_band=kb)
    v_k = mf._xc_eval(dm_dev, nspin)[1][:, 1:]
    assert np.abs(v_b - v_k).max() <= 1e-10 * np.abs(v_k).max()
    if mf._hub_sites is not None:
        u_b = mf._hubbard_vu_bands(dm_s, s1e_b)
        u_k = mf._hubbard_eu_vu(dm_s)[1][:, 1:]
        assert np.abs(u_b - u_k).max() <= 1e-10 * np.abs(u_k).max()


def test_scan_fock_is_exact_derivative(diamond):
    """FD of Exc along a random hermitian ddm against Tr(ddm Vxc)/nk: the
    whole tau plumbing (Bloch AO gradients, tau, the v_tau matrix)."""
    mf = diamond[3]("krks_scan")
    nk = len(mf.kpts)
    rng = np.random.default_rng(11)
    ddm = rng.standard_normal(mf.dm.shape) * 1e-4
    ddm = ddm + ddm.transpose(0, 2, 1)

    def exc_of(d):
        exc, vxc, _, _, _ = xc_mod.xc_pass(
            mf._get_ao(), mf._dm_device(d)[None], mf._gv, mf._spec,
            mf._fmesh, mf._xc_weight, nk, 1, coords=mf._coords,
            kpts=mf._kpts_arr)
        return float(exc), vxc.numpy()

    _, vxc = exc_of(mf.dm)
    fd = (exc_of(mf.dm + ddm)[0] - exc_of(mf.dm - ddm)[0]) / 2.0
    an = float(np.einsum("kmn,knm->", ddm, vxc[0]).real) / nk
    assert abs(fd - an) < 1e-7 * max(abs(fd), 1e-8), (fd, an)
