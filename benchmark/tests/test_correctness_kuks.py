"""The comparison that decides ``correct`` in a KUKS-PBE+U cell
(``benchmark/reference/uks.py``), at a tiny size on the CPU
(``tests/data/nio_afm_pbeu_szv_tiny.json``: NiO gth-szv, ke 100, 1x1x2,
with the cell configuration's functional, +U, smearing and limits).

The reference's parts are held to the program's on a seeded random
density that keeps time reversal: the reference is written apart from
the program, so these are two witnesses of one definition.  A sound run
is correct; the control (the program in float32, the precision below the
configuration's) and each planted fault are not: the xc potential of one
spin dropped, the +U term dropped, the energy altered by 1e-3 Ha.  The
chip runs at the cell's own size are in PERF.md."""
import json

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import program
from benchmark.harness import spec as spec_mod
from benchmark.harness.geometry import geometry

TINY = "benchmark/tests/data/nio_afm_pbeu_szv_tiny.json"
CELL_CONFIG = "nio_afm_pbeu_dzvp_k444"


def tiny_run(control=False):
    spec = spec_mod.load_spec()
    spec["configs"].append({"name": "tiny", "file": TINY})
    spec["workloads"].append({"name": "tiny.kuks_pbeu", "config": "tiny",
                              "traffic": "kuks_pbeu", "chips": 1})
    argv = ["--workload", "tiny.kuks_pbeu", "--seed", "314159265358",
            "--seconds", "0.01", "--trace", "0"]
    args = bench_run.parse_args(argv + (["--control"] if control else []))
    return bench_run.run(args, torch.device("cpu"), spec)


def test_tiny_settings_are_the_cells():
    tiny = json.load(open(spec_mod.ROOT / TINY))
    cfg = spec_mod.load_config(spec_mod.load_spec(), CELL_CONFIG)
    for key in ("limits", "scf", "control", "conv_tol", "fit_ridge"):
        assert tiny[key] == cfg[key], key


def test_reference_parts_agree_with_the_program():
    """Overlap, core Hamiltonian, J, Exc and the Vxc matrices, E_U and
    V_U of a seeded random density with time reversal, the reference
    against the program, and the total energy of that density."""
    from benchmark.reference.uks import Reference

    cfg = json.load(open(spec_mod.ROOT / TINY))
    dev = torch.device("cpu")
    geom = geometry(cfg, 271828, 0)
    cell, kpts = program.make_cell(cfg, *geom)
    df = program.make_isdf(cfg, cell, kpts, torch.float64, dev).build()
    mf = program.make_scf(cfg, {"scf": {"driver": "DeviceKUKS"}}, cell,
                          kpts, df, torch.float64, 1e-8, dev)
    ref = Reference(cfg, geom, dev)
    s1e, h1e = (torch.as_tensor(np.asarray(m)) for m in (mf.s1e, mf.h1e))
    # one quadrature of the same Bloch functions on the same mesh: rounding
    assert float((ref.s1e - s1e).abs().max()) < 1e-12
    # the reference keeps the time-reversal symmetric part of H
    assert float((ref.h1e - ref.time_reversed(h1e)).abs().max()) < 1e-12

    gen = torch.Generator().manual_seed(20260418)
    nk, nao = s1e.shape[:2]
    a = torch.complex(*(torch.randn((2, 2, nk, nao, nao), generator=gen,
                                    dtype=torch.float64)))
    guess = torch.as_tensor(np.asarray(mf.get_init_guess()))
    dm = ref.time_reversed(guess + 0.02 * a @ a.mH)
    dm_np = dm.numpy()

    vj, _ = df.get_jk(dm)
    # two solves of one ridge-regularised fit (the program's split
    # factorisation, the reference's Cholesky): ~1e-9 apart, as uhf.py's
    assert float((ref.get_j(dm) - vj[0] - vj[1]).abs().max()) < 1e-8
    # the same discrete functional on the same mesh: rounding of sums
    # over the mesh (|Exc| ~ 1e2 Ha)
    exc, vxc, _ = mf._xc_eval(mf._dm_device(dm_np), 2)
    rexc, v = ref.exc_and_v(ref.rho_grid(dm))
    assert abs(rexc - exc) < 1e-10, (rexc, exc)
    assert float((ref.vxc_matrices(v) - torch.as_tensor(vxc)).abs().max()) \
        < 1e-10
    # the same small matrices, S^1/2 from two eigensolvers
    eu, vu = mf._hubbard_eu_vu(dm_np)
    reu, rvu = ref.hubbard(dm)
    assert eu != 0.0 and abs(reu - eu) < 1e-12, (reu, eu)
    assert float((rvu - torch.as_tensor(vu)).abs().max()) < 1e-12
    # the total: J's 1e-9 (and H's time reversal) against a 1e-5 Ha/atom
    # limit
    fock, vj_h, vk_h = mf.get_fock(dm_np)
    e_prog = mf.energy_elec(dm_np, vj_h, vk_h) + mf.e_nuc
    assert abs(ref.fock_energy(dm)[1] - e_prog) < 1e-7


def test_sound_run_is_correct():
    res = tiny_run()
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["energy_gap"]["value"] < 1e-7


def test_control_is_not_correct():
    res = tiny_run(control=True)
    assert not res["correct"]
    assert res["checks"]["energy_gap"]["value"] > \
        res["checks"]["energy_gap"]["limit"]


def _one_spin_dropped(xc_pass):
    def dropped(*a, **kw):
        exc, vxc, nelec, v, vt = xc_pass(*a, **kw)
        if vxc is not None:
            vxc = vxc.clone()
            vxc[1] = 0.0              # the minority spin's potential left out
        return exc, vxc, nelec, v, vt
    return dropped


def _answer_altered(kernel):
    def altered(self, dm0=None):
        self.e_tot = kernel(self, dm0) + 1e-3
        return self.e_tot
    return altered


@pytest.mark.parametrize("fault", ["vxc_one_spin_dropped", "hubbard_dropped",
                                   "answer_altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    from fftisdf_tpu_torch.scf import DeviceKUKS
    from fftisdf_tpu_torch.scf import hubbard as hub_mod
    from fftisdf_tpu_torch.scf import xc as xc_mod

    if fault == "vxc_one_spin_dropped":
        monkeypatch.setattr(xc_mod, "xc_pass",
                            _one_spin_dropped(xc_mod.xc_pass))
    elif fault == "hubbard_dropped":
        # no +U site: E_U and V_U are left out, on the card and the host
        monkeypatch.setattr(hub_mod, "build_sites", lambda cell, hub: [])
    else:
        monkeypatch.setattr(DeviceKUKS, "kernel",
                            _answer_altered(DeviceKUKS.kernel))
    res = tiny_run()
    assert not res["correct"], res["checks"]
