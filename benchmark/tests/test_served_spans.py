"""CPU tests of the readers of a served job's spans
(``benchmark/harness/served_spans.py``) and of the xc pass's shape-only
count (``benchmark/harness/xc_count.py``): the count at the production
shape, each reader on a synthetic digest and None where its span is
absent, and a traced tiny KUKS-PBE+U run that reads them from the
program on the run's own state."""
import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import program_spans as ps
from benchmark.harness import spec as spec_mod
from benchmark.harness.xc_count import xc_bound

TINY = "benchmark/tests/data/nio_afm_pbeu_szv_tiny.json"
CELL = "nio_dzvp_k444.kuks_pbeu"
SPEC = spec_mod.load_spec()
SPAN_READERS = {"xc_ms.kuks_pbeu": "scf.xc", "jk_ms.kuks_pbeu": "scf.jk",
                "eigh_ms.kuks_pbeu": "scf.eigh",
                "hubbard_ms.kuks_pbeu": "scf.hubbard"}


def test_xc_count_at_the_production_shape():
    """NiO dzvp 4x4x4: 2 x 2 spins x 64 k-points x 8 ng nao^2 and 16 FFTs;
    the AO tensor (15.9 GB in complex128) read twice."""
    flops, nbytes, sec, by = xc_bound(64, 250047, 62, 2)
    assert flops == pytest.approx(1.96886e12, rel=1e-5)
    assert nbytes == pytest.approx(3.17657e10, rel=1e-5)
    assert round(1e3 * sec, 3) == 29.386 and by == "operations"
    _, b32, sec32, _ = xc_bound(64, 250047, 62, 2, "complex64")
    assert b32 < nbytes and sec32 == sec          # FP32's peak is FP64's


def _digest(spans, cycles=4):
    rec = {"spans": [], "counts": {"scf.xc_kblocks": 28}}
    seq = 0
    for name, (n, device_s) in spans.items():
        for _ in range(n):
            rec["spans"].append({"name": name, "parent": "scf.cycle",
                                 "seq": seq, "parent_seq": None,
                                 "host_s": device_s / n,
                                 "device_s": device_s / n})
            seq += 1
    for _ in range(cycles):
        rec["spans"].append({"name": "scf.cycle", "parent": None, "seq": seq,
                             "parent_seq": None, "host_s": 0.3,
                             "device_s": 0.3})
        seq += 1
    job = {"e_tot": -369.69, "cycles": cycles, "cycle_ms": 300.0,
           "xc_shape": (64, 250047, 62), "complex": "complex128"}
    return ps.digest(rec, None, job)


def test_readers_on_a_synthetic_digest():
    d = _digest({"scf.xc": (4, 0.72), "scf.jk": (4, 0.008),
                 "scf.eigh": (4, 0.44), "scf.hubbard": (4, 0.012)})
    for name, span in SPAN_READERS.items():
        rd = spec_mod.metric_reader(name)
        got = rd.read({"probes": {name: d}})
        assert got == pytest.approx(1e3 * d["spans"][span]["device_s"] / 4)
    rd = spec_mod.metric_reader("xc_roofline.kuks_pbeu")
    got = rd.read({"probes": {"xc_roofline.kuks_pbeu": d}})
    assert got == pytest.approx(100.0 * 29.38592 / 180.0, rel=1e-5)


def test_readers_without_their_spans_read_nothing():
    """The parent of the +U span, or a run without the probe, gives
    None and no error."""
    d = _digest({"scf.xc": (4, 0.72)})
    rd = spec_mod.metric_reader("hubbard_ms.kuks_pbeu")
    assert rd.read({"probes": {"hubbard_ms.kuks_pbeu": d}}) is None
    for name in list(SPAN_READERS) + ["xc_roofline.kuks_pbeu"]:
        assert spec_mod.metric_reader(name).read({"probes": {}}) is None


def test_every_new_metric_lists_the_cell():
    new = [m for m in SPEC["per_layer"] if m["name"].endswith(".kuks_pbeu")]
    assert len(new) == 9
    assert all(m["workloads"] == [CELL] and m["moves"] == "job_s"
               for m in new)
    assert {m["name"] for m in spec_mod.per_layer_metrics(SPEC, CELL)} == \
        {m["name"] for m in new}


def test_traced_tiny_run_reads_the_served_job(monkeypatch, capfd):
    """A traced tiny run on the CPU: every span reader and the counters
    read the served job on the run's own state (the CPU has no device
    trace, so idle_share reads nothing)."""
    load = spec_mod.load_traffic

    def short(name):
        mix = load(name)
        mix["trace_seconds"] = 0.01
        return mix

    monkeypatch.setattr(spec_mod, "load_traffic", short)
    spec = spec_mod.load_spec()
    spec["configs"].append({"name": "tiny", "file": TINY})
    spec["workloads"].append({"name": "tiny.kuks_pbeu", "config": "tiny",
                              "traffic": "kuks_pbeu", "chips": 1})
    for m in spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"] = ["tiny.kuks_pbeu"]
    args = bench_run.parse_args(["--workload", "tiny.kuks_pbeu", "--seed",
                                 "27182818284", "--seconds", "0.01",
                                 "--trace", "1"])
    res = bench_run.run(args, torch.device("cpu"), spec)
    err = capfd.readouterr().err
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for name in list(SPAN_READERS) + ["xc_roofline.kuks_pbeu",
                                      "cycle_ms.kuks_pbeu",
                                      "cycles.kuks_pbeu"]:
        assert got[name]["value"] > 0.0, name
    assert "idle_share.kuks_pbeu" not in got
    assert "served spans: cycle parts" in err
    assert "scf.xc_kblocks" in err
    json.dumps(res)
