"""The comparison that decides ``correct``, shown to fail: the control
(the program in float32, the precision below the configuration's) and
each fault a cell of this benchmark can have, planted in the program
underneath a run that skips only the harness's look for a card.  A tiny
NiO configuration on the CPU (``tests/data/nio_afm_szv_tiny.json``, the
cell configuration's limits); the chip runs of the control at the cell's
own size are in PERF.md.  The reference's parts are held to the
program's at that size too: the reference is written apart from the
program, so these are two witnesses of one definition."""
import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import spec as spec_mod

TINY = "benchmark/tests/data/nio_afm_szv_tiny.json"


def tiny_run(monkeypatch=None, control=False, traffic="job"):
    spec = spec_mod.load_spec()
    spec["configs"].append({"name": "tiny", "file": TINY})
    spec["workloads"].append({"name": "tiny." + traffic, "config": "tiny",
                              "traffic": traffic, "chips": 1})
    argv = ["--workload", "tiny." + traffic, "--seed", "314159265358",
            "--seconds", "0.01", "--trace", "0"]
    args = bench_run.parse_args(argv + (["--control"] if control else []))
    return bench_run.run(args, torch.device("cpu"), spec)


def test_tiny_limits_are_the_cells():
    tiny = json.load(open(spec_mod.ROOT / TINY))
    spec = spec_mod.load_spec()
    cfg = spec_mod.load_config(spec, "nio_afm_dzvp_k222")
    assert tiny["limits"] == cfg["limits"]


@pytest.mark.parametrize("traffic", ["job", "serve_kuhf"])
def test_sound_run_is_correct(traffic):
    res = tiny_run(traffic=traffic)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)


def test_reference_agrees_with_the_program():
    """Overlap, core Hamiltonian, ion energy, interpolation points and J/K
    of a time-reversal symmetric density, the reference against the
    program, at the tiny size on the CPU."""
    import numpy as np

    from benchmark.harness import program
    from benchmark.harness.geometry import geometry
    from benchmark.reference.uhf import Reference

    cfg = json.load(open(spec_mod.ROOT / TINY))
    dev = torch.device("cpu")
    geom = geometry(cfg, 271828, 0)
    cell, kpts = program.make_cell(cfg, *geom)
    df = program.make_isdf(cfg, cell, kpts, torch.float64, dev).build()
    mf = program.make_scf(cfg, {"scf": {"driver": "DeviceKUHF"}}, cell,
                          kpts, df, torch.float64, 1e-8, dev)
    ref = Reference(cfg, geom, dev)
    s1e, h1e = (torch.as_tensor(np.asarray(m)) for m in (mf.s1e, mf.h1e))
    assert float((ref.s1e - s1e).abs().max()) < 1e-12
    # the reference keeps the time-reversal symmetric part of H
    assert float((ref.h1e - ref.time_reversed(h1e)).abs().max()) < 1e-12
    assert abs(ref.e_nuc - mf.e_nuc) < 1e-10
    assert float((ref.x - df.x_k).abs().max()) < 1e-12
    dm = ref.time_reversed(torch.as_tensor(
        np.asarray(mf.get_init_guess()), dtype=torch.complex128))
    vj, vk = df.get_jk(dm)
    rj, rk = ref.get_jk(dm)
    assert float((rj - vj[0] - vj[1]).abs().max()) < 1e-8
    assert float((rk - vk).abs().max()) < 1e-8


def test_control_is_not_correct():
    res = tiny_run(control=True)
    assert not res["correct"]
    assert res["checks"]["energy_gap"]["value"] > \
        res["checks"]["energy_gap"]["limit"]


def _state_unchanged(self, dm0=None):
    """The SCF returns the density it started from."""
    dm = self.get_init_guess()
    fock, vj, vk = self.get_fock(dm)
    self.dm, self.converged, self.cycles = dm, True, 1
    self.cycle_times = [0.0]
    self.e_tot = float(self.energy_elec(dm, vj, vk) + self.e_nuc)
    return self.e_tot


def _answer_altered(kernel):
    def altered(self, dm0=None):
        self.e_tot = kernel(self, dm0) + 1e-3
        return self.e_tot
    return altered


def _half_batch(get_j):
    def half(x_k, w0, dm, *a, **kw):
        dm = dm.clone()
        dm[..., 1::2, :, :] = 0.0        # half the k-points left out,
        dm[..., 0::2, :, :] *= 2.0       # the mean taken over the rest
        return get_j(x_k, w0, dm, *a, **kw)
    return half


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    from fftisdf_tpu_torch.isdf import jk
    from fftisdf_tpu_torch.scf.device import DeviceKUHF

    if fault == "state_unchanged":
        monkeypatch.setattr(DeviceKUHF, "kernel", _state_unchanged)
    elif fault == "answer_altered":
        monkeypatch.setattr(DeviceKUHF, "kernel",
                            _answer_altered(DeviceKUHF.kernel))
    else:
        monkeypatch.setattr(jk, "get_j_kpts", _half_batch(jk.get_j_kpts))
    res = tiny_run()
    assert not res["correct"], res["checks"]
