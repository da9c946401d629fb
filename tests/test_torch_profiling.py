"""The port's span recorder (``utils.profiling``) and the spans the program
carries through the ISDF build and the device SCF loop (CPU, f64).

Off (the default) a span is one shared null context and records nothing;
on, spans nest by the stack, keep ``time.time_ns()`` host times and
drain once.  A recorded diamond build and DeviceKUHF hold the span
counts the benchmark's readers divide by (one ``scf.cycle``, ``scf.jk``,
``scf.eigh`` and ``scf.occ`` per cycle) and return ``wq``, ``mask`` and
``e_tot`` bitwise equal to the unrecorded run's (the metric pass's
budget is pinned, so both runs chunk alike).  The card's clock check
(K1's kernels inside ``isdf.select``) is
tests/test_torch_gpu.py::test_spans_hold_their_kernels_on_cuda.
"""
import time
from collections import Counter

import numpy as np
import pytest
import torch

from fftisdf_tpu_torch.isdf import FFTISDF
from fftisdf_tpu_torch.isdf.kpoint import STAGE_SPANS
from fftisdf_tpu_torch.lattice import structure
from fftisdf_tpu_torch.scf import DeviceKUHF
from fftisdf_tpu_torch.utils import profiling
from torch_test_threads import two_torch_threads  # noqa: F401


def _job():
    """A diamond gth-szv 1x1x2 build and a smeared DeviceKUHF on it."""
    cell = structure.to_cell(*structure.bulk_diamond(), basis="gth-szv",
                             pseudo="gth-pade", ke_cutoff=50.0)
    kpts = cell.get_kpts([1, 1, 2])
    df = FFTISDF(cell, kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                 max_memory_gb=1.0, device="cpu").build()
    mf = DeviceKUHF(cell, kpts, df, verbose=0, conv_tol=1e-9, smearing=5e-3,
                    max_cycle=60, device="cpu")
    mf.kernel()
    return df, mf


@pytest.fixture(scope="module")
def runs():
    """(plain (df, mf), recorded (df, mf), the recorded run's drain)."""
    plain = _job()
    assert profiling.drain() == {"spans": [], "counts": {}}
    with profiling.recording():
        recorded = _job()
        rec = profiling.drain()
    return plain, recorded, rec


def test_off_is_free_and_records_nothing(runs):
    assert profiling.span("a") is profiling.span("b")
    assert profiling.count("scf.adiis_taken") is None
    with profiling.span("isdf.build"):
        profiling.count("x", 3)
    assert profiling.drain() == {"spans": [], "counts": {}}


def test_spans_nest_with_time_ns_and_drain_clears():
    with profiling.recording():
        t0 = time.time_ns()
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("c")
            profiling.count("c", 2)
            with profiling.span("inner"):
                pass
        t1 = time.time_ns()
        rec = profiling.drain()
        assert profiling.drain() == {"spans": [], "counts": {}}
    names = [s["name"] for s in rec["spans"]]
    assert names == ["inner", "inner", "outer"]      # closing order
    outer = rec["spans"][-1]
    assert outer["parent"] is None and outer["parent_seq"] is None
    for s in rec["spans"][:2]:
        assert s["parent"] == "outer" and s["parent_seq"] == outer["seq"]
        assert outer["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= outer["t1_ns"]
    assert t0 <= outer["t0_ns"] and outer["t1_ns"] <= t1
    for s in rec["spans"]:
        assert s["host_s"] == pytest.approx((s["t1_ns"] - s["t0_ns"]) * 1e-9)
        assert s["device_s"] == s["host_s"]          # the CPU: host seconds
    assert rec["counts"] == {"c": 3}


def test_recording_end_drops_what_was_not_drained():
    with profiling.recording():
        with profiling.span("left"):
            profiling.count("c")
    with profiling.recording():
        assert profiling.drain() == {"spans": [], "counts": {}}


def test_profiled_build_inside_a_recording_leaves_its_spans(runs):
    """A profile_build build nested in an outer recording fills _stage_s
    from its own spans and leaves them for the outer drain."""
    (df, _), _, _ = runs
    with profiling.recording():
        prof = FFTISDF(df.cell, df.kpts, c0=10.0, m0=(9, 9, 9), verbose=0,
                       max_memory_gb=1.0, profile_build=True,
                       device="cpu").build()
        rec = profiling.drain()
    by = Counter(s["name"] for s in rec["spans"])
    assert by["isdf.build"] == 1
    for key, names in STAGE_SPANS.items():
        want = sum(s["device_s"] for s in rec["spans"] if s["name"] in names)
        assert prof._stage_s[key] == pytest.approx(want)
    assert torch.equal(prof.wq, df.wq)


def test_recorded_job_counts(runs):
    _, (df, mf), rec = runs
    by = Counter(s["name"] for s in rec["spans"])
    n = mf.cycles
    assert mf.converged and n > 3
    assert by["scf.cycle"] == n == len(mf.cycle_times)
    for name in ("scf.jk", "scf.diis", "scf.cdiis", "scf.eigh", "scf.occ",
                 "scf.fetch"):
        assert by[name] == n, name
    for name in ("isdf.build", "isdf.select", "isdf.select.ao",
                 "isdf.select.k1", "isdf.select.pivot", "isdf.factors",
                 "scf.one_electron", "scf.kernel", "scf.prepare",
                 "scf.finish"):
        assert by[name] == 1, name
    assert by["isdf.sweep"] == by["isdf.solve"] == df.nchunks
    assert by["isdf.solve.gram"] == len(df.kpts)  # every sector solved
    counts = rec["counts"]
    assert 0 <= counts["scf.adiis_taken"] <= by["scf.adiis"] <= n
    assert set(counts) == {"scf.adiis_taken"}


def test_recorded_job_parents(runs):
    _, _, rec = runs
    parent = {s["name"]: s["parent"] for s in rec["spans"]}
    assert parent["isdf.build"] is None and parent["scf.kernel"] is None
    for child, par in [("isdf.select", "isdf.build"),
                       ("isdf.select.k1", "isdf.select"),
                       ("isdf.sweep.ao", "isdf.sweep"),
                       ("isdf.solve.fft", "isdf.solve"),
                       ("isdf.solve", "isdf.build"),
                       ("scf.cycle", "scf.kernel"),
                       ("scf.jk", "scf.cycle"), ("scf.cdiis", "scf.diis"),
                       ("scf.adiis", "scf.diis"), ("scf.fetch", "scf.cycle"),
                       ("scf.finish", "scf.kernel")]:
        assert parent[child] == par, child
    seq = {s["seq"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        if s["parent_seq"] is not None:
            p = seq[s["parent_seq"]]
            assert p["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= p["t1_ns"]
    cycles = sum(s["host_s"] for s in rec["spans"] if s["name"] == "scf.cycle")
    parts = sum(s["host_s"] for s in rec["spans"]
                if s["parent"] == "scf.cycle")
    assert parts <= cycles


def test_recording_changes_no_result(runs):
    (df0, mf0), (df1, mf1), _ = runs
    assert np.array_equal(df0.mask, df1.mask)
    assert torch.equal(df0.wq, df1.wq)
    assert mf0.e_tot == mf1.e_tot and mf0.cycles == mf1.cycles
    assert np.array_equal(mf0.dm, mf1.dm)
