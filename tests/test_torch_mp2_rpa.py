"""The port's k-point MP2 (``scf.mp2``) and direct RPA (``scf.rpa``)
against the JAX package's, on the CPU in float64.

The H2 chain of tests/test_mp2.py at gamma and on the 1x1x2 mesh (c0 60,
m0 11x11x13, full rank): the port builds on the JAX package's
interpolation points and runs the methods on the JAX package's converged
KRHF orbitals (and the spin-2 KUHF's), all recorded in
tests/data/jax_port_refs.json by ``tools/jax_port_refs.py many_body``, so
kmp2, kump2 and drpa are held to the JAX energies at 1e-10 relative.  The
port alone: kump2 of a closed shell (the KRHF orbitals in both spin
channels) equals kmp2 (1e-10 relative), and at gamma kmp2 and drpa equal
independent dense ov-space oracles built from the port's exact plane-wave
MO ERIs (1e-6, tests/test_mp2.py's and tests/test_rpa.py's gates).
"""
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from fftisdf_tpu_torch.basis.eval import make_evaluator
from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.lattice.cell import Cell, Shell
from fftisdf_tpu_torch.pw import get_eri_from_ao
from fftisdf_tpu_torch.scf import KRHF, KUHF
from fftisdf_tpu_torch.scf.hf import _build_dm
from fftisdf_tpu_torch.scf.mp2 import kmp2, kump2
from fftisdf_tpu_torch.scf.rpa import drpa, drpa_ov_space
from torch_test_threads import two_torch_threads  # noqa: F401

REFS = json.loads((Path(__file__).resolve().parent / "data"
                   / "jax_port_refs.json").read_text())["many_body"]
ISDF_KW = dict(c0=60.0, m0=(11, 11, 13), verbose=0, select_tol=1e-18,
               rcond=1e-12, device="cpu")


def h2_cell(nz=1, lz=7.0, spin=0):
    """tests/test_mp2.py::h2_cell."""
    atoms = []
    for i in range(nz):
        atoms += [("H", (3.0, 3.0, 1.8 + lz * i)),
                  ("H", (3.0, 3.0, 3.2 + lz * i))]
    return Cell(
        a=np.diag([6.0, 6.0, lz * nz]), atom=atoms,
        basis={"H": [Shell(l=0, exps=np.array([1.2, 0.4]),
                           coeffs=np.eye(2))]},
        pseudo="gth-pade",
        mesh=np.array([14, 14, int(14 * nz * lz / 6) // 2 * 2 + 1]),
        unit="bohr", spin=spin, precision=1e-12).build()


def unpack(d):
    """{shape, re, im} of tools/jax_port_refs.py -> complex array."""
    return (np.asarray(d["re"]) + 1j * np.asarray(d["im"])).reshape(
        d["shape"])


def with_orbitals(mf, rec):
    """``mf`` given a recorded reference's orbitals and density."""
    mf.mo_coeff = unpack(rec["mo_coeff"])
    mf.mo_energy = np.asarray(rec["mo_energy"])
    mf.mo_occ = np.asarray(rec["mo_occ"])
    if mf.mo_coeff.ndim == 4:
        mf.dm = np.stack([_build_dm(mf.mo_coeff[s], mf.mo_occ[s])
                          for s in range(2)])
    else:
        mf.dm = _build_dm(mf.mo_coeff, mf.mo_occ)
    return mf


@lru_cache(maxsize=None)
def h2_state(key):
    """(cell, kpts, df, KRHF with the JAX orbitals) of ``key`` in
    {'h2_gamma', 'h2_k2'}; the port's build on the JAX points."""
    rec = REFS[key]
    cell = h2_cell()
    kpts = np.zeros((1, 3)) if key == "h2_gamma" else cell.get_kpts(
        [1, 1, 2])
    df = FFTISDF(cell, kpts, **ISDF_KW).build(mask=np.asarray(rec["mask"]))
    mf = with_orbitals(KRHF(cell, kpts, df, verbose=0, device="cpu"),
                       rec["krhf"])
    return cell, kpts, df, mf


def closed_shell_u(mf):
    """A KUHF holding the KRHF orbitals in both spin channels."""
    u = KUHF(mf.cell, mf.kpts, mf.with_df, verbose=0, device="cpu")
    u.mo_coeff = np.stack([mf.mo_coeff] * 2)
    u.mo_energy = np.stack([mf.mo_energy] * 2)
    u.mo_occ = np.stack([mf.mo_occ] * 2) * 0.5
    u.dm = np.stack([mf.dm] * 2) * 0.5
    return u


def rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("key", ["h2_gamma", "h2_k2"])
def test_kmp2_and_drpa_match_jax(key):
    _, _, df, mf = h2_state(key)
    e2, info = kmp2(df, mf)
    assert abs(info["imag"]) < 1e-10 and e2 < 0
    assert rel(e2, REFS[key]["kmp2"]) < 1e-10, (e2, REFS[key]["kmp2"])
    ec, info = drpa(df, mf, nw=24)
    assert info["nocc"] == 1 and ec < 0
    assert rel(ec, REFS[key]["drpa"]) < 1e-10, (ec, REFS[key]["drpa"])


@pytest.mark.parametrize("key", ["h2_gamma", "h2_k2"])
def test_kump2_closed_shell_equals_kmp2(key):
    """The spin-resolved sum reduces exactly to the restricted one; the
    same-spin part is the exchange-antisymmetrised remainder."""
    _, _, df, mf = h2_state(key)
    e_r, _ = kmp2(df, mf)
    e_u, info = kump2(df, closed_shell_u(mf))
    assert info["nocc"] == (1, 1) and abs(info["imag"]) < 1e-10
    assert rel(e_u, e_r) < 1e-10, (e_u, e_r)
    assert info["e_ss"][0] == info["e_ss"][1]
    assert abs(sum(info["e_ss"]) + info["e_os"] - e_u) < 1e-14


def test_kump2_open_shell_matches_jax():
    """The spin-2 H2 stretch (nocc (2, 0)) on the JAX package's KUHF
    orbitals: distinct alpha/beta occupations, one channel empty."""
    rec = REFS["h2_k2"]
    _, kpts, df, _ = h2_state("h2_k2")
    mf = with_orbitals(KUHF(h2_cell(spin=2), kpts, df, verbose=0,
                            device="cpu"), rec["kuhf_spin2"])
    e2, info = kump2(df, mf)
    assert info["nocc"] == (2, 0) and abs(info["imag"]) < 1e-10
    assert e2 < 0 and info["e_os"] == 0.0
    assert rel(e2, rec["kump2_spin2"]) < 1e-10, (e2, rec["kump2_spin2"])


def _dense_mp2(eri, mo_e, nocc):
    """Molecular closed-shell MP2 from a dense MO ERI (mn|kl)."""
    o, v = slice(None, nocc), slice(nocc, None)
    g = eri[o, v, o, v]
    d = (mo_e[o][:, None, None, None] - mo_e[v][None, :, None, None]
         + mo_e[o][None, None, :, None] - mo_e[v][None, None, None, :])
    return float(np.sum(g * (2 * g.conj() - g.transpose(0, 3, 2, 1).conj())
                        / d).real)


def test_gamma_matches_dense_oracles():
    """Full-rank ISDF at gamma: kmp2 and drpa equal the ov-space sums over
    exact plane-wave MO ERIs of the same orbitals."""
    cell, kpts, df, mf = h2_state("h2_gamma")
    coords = cell.gen_uniform_grids()
    ao = make_evaluator(cell, kpts=kpts, device="cpu")(coords)[0]
    mo = ao @ torch.as_tensor(mf.mo_coeff[0])
    eri = get_eri_from_ao(cell, (mo,) * 4, np.zeros(3), coords).numpy()
    mo_e = mf.mo_energy[0]
    assert abs(kmp2(df, mf)[0] - _dense_mp2(eri, mo_e, 1)) < 1e-6
    ref = drpa_ov_space(eri[:1, 1:, :1, 1:], mo_e[:1], mo_e[1:], nw=24)
    assert abs(drpa(df, mf, nw=24)[0] - ref) < 1e-6
