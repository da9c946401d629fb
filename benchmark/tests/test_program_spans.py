"""CPU tests of the readers of the program's own spans
(``benchmark/harness/program_spans.py`` and the metrics that use it): the
idle arithmetic on hand-made timelines, beside the trace reduction it
leaves as it was; each reader on a synthetic run record, and None where
its spans are absent; the job it reads, fixed by the seed and held to
the window's; a traced run of the tiny configuration on the CPU that
reads them from the program."""
import json
import sys

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import program_spans as ps
from benchmark.harness import spec as spec_mod
from benchmark.harness.tracing import reduce_trace

TINY = "benchmark/tests/data/nio_afm_szv_tiny.json"
SPEC = spec_mod.load_spec()
NEW = {  # metric: what it reads of the synthetic record
    "jk_ms.job": 1e3 * 0.2 / 4, "diis_ms.job": 1e3 * 0.6 / 4,
    "eigh_ms.job": 1e3 * 0.1 / 4, "occ_ms.job": 1e3 * 0.05 / 4,
    "scf_finish_s.job": 0.3, "adiis_taken.job": 50.0,
    "select_pivot_s.job": 0.4, "sweep_ao_s.job": 0.7,
    "solve_fft_s.job": 0.5, "solve_gram_s.job": 2.5,
    "build_idle_share.job": 10.0, "scf_idle_share.job": 40.0}


class _Event:
    def __init__(self, name, t0, t1, cuda=True, annotation=False):
        self._v = (name, t0, t1 - t0, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    """What reduce_trace reads of a profiler run."""

    def __init__(self, events):
        ev = [_Event(*e) for e in events]
        kin = type("K", (), {"events": lambda self: ev})()
        self.profiler = type("P", (), {"kineto_results": kin})()


# device activity: busy 0-100, 105-200 (a 5 us gap), 300-400 and 430-500
# (gaps of 100 and 30 us); times in ns x 1000
US = 1000
EVENTS = [("k1", 0, 100 * US), ("gemm", 105 * US, 200 * US),
          ("gemm", 150 * US, 180 * US), ("fft", 300 * US, 400 * US),
          ("eigh", 430 * US, 500 * US), ("host_op", 200 * US, 300 * US,
                                        False)]
SPANS = [  # (name, t0, t1, seq, parent_seq): properly nested
    ("isdf.build", 0, 250 * US, 0, None),
    ("isdf.select", 0, 110 * US, 1, 0),
    ("scf.kernel", 250 * US, 520 * US, 2, None),
    ("scf.cycle", 260 * US, 450 * US, 3, 2)]


def _span(name, t0, t1, seq, parent_seq):
    return {"name": name, "parent": None, "seq": seq,
            "parent_seq": parent_seq, "t0_ns": t0, "t1_ns": t1,
            "host_s": (t1 - t0) * 1e-9, "device_s": (t1 - t0) * 1e-9}


def test_reduce_trace_is_the_same_beside_program_spans():
    """The program's spans reach a profiler run as ranges
    (``record_function``: user annotations, on the host and mirrored on
    the device): the trace reduction's summary is the same with them as
    without, and the program spans' idle over the whole window is the
    reduction's."""
    bench = [(0, 520 * US, "job.build")]
    ranges = [(n, t0, t1, cuda, True) for n, t0, t1, _, _ in SPANS
              for cuda in (True, False)]
    a = reduce_trace(_Prof(EVENTS), bench, 520e-6)
    b = reduce_trace(_Prof(EVENTS + ranges), list(bench), 520e-6)
    assert a == b
    assert a["busy_s"] == pytest.approx(365e-6)
    assert a["idle_by_label"]["(gaps under 20 us)"] == pytest.approx(5e-6)
    dev = [e[1:3] for e in EVENTS if len(e) == 3]
    whole = ps.idle_in_spans([_span("all", 0, 520 * US, 0, None)], dev)
    span_s, idle_s, _ = whole["all"]
    assert span_s == pytest.approx(a["window_s"])
    assert idle_s == pytest.approx(a["window_s"] - a["busy_s"])


def test_idle_inside_spans_by_hand():
    dev = [e[1:3] for e in EVENTS if len(e) == 3]
    out = ps.idle_in_spans([_span(*s) for s in SPANS], dev)
    # isdf.build 0-250: busy 0-100, 105-200 -> idle 5 + 50 us
    assert out["isdf.build"][:2] == pytest.approx((250e-6, 55e-6))
    # isdf.select 0-110: busy 0-100, 105-110 -> idle 5 us
    assert out["isdf.select"][:2] == pytest.approx((110e-6, 5e-6))
    # scf.kernel 250-520: busy 300-400, 430-500 -> idle 50 + 30 + 20 us
    assert out["scf.kernel"][:2] == pytest.approx((270e-6, 100e-6))
    # scf.cycle 260-450: busy 300-400, 430-450 -> idle 40 + 30 us
    assert out["scf.cycle"][:2] == pytest.approx((190e-6, 70e-6))
    # the gaps by innermost span at their middles: 100-105 (select),
    # 200-300 (middle 250: scf.kernel opens there), 400-430 (cycle)
    assert out["isdf.select"][2] == pytest.approx(5e-6)
    assert out["isdf.build"][2] == pytest.approx(0.0)
    assert out["scf.kernel"][2] == pytest.approx(100e-6)
    assert out["scf.cycle"][2] == pytest.approx(30e-6)


def _synthetic_record():
    """A drained recording of one job: 4 cycles, with its profiled twin."""
    spans, seq = [], iter(range(1000))

    def add(name, dev_s, parent=None, host_s=None):
        s = {"name": name, "parent": parent and parent["name"],
             "seq": next(seq), "parent_seq": parent and parent["seq"],
             "t0_ns": 0, "t1_ns": 0, "host_s": host_s or dev_s,
             "device_s": dev_s}
        spans.append(s)
        return s

    kern = add("scf.kernel", 5.0)
    for _ in range(4):
        cyc = add("scf.cycle", 0.25, kern)
        for name, t in (("scf.jk", 0.05), ("scf.diis", 0.15),
                        ("scf.eigh", 0.025), ("scf.occ", 0.0125)):
            s = add(name, t, cyc)
            if name == "scf.diis":
                add("scf.adiis", 0.1, s)
    add("scf.finish", 0.1, kern, host_s=0.3)
    build = add("isdf.build", 7.0)
    add("isdf.select.pivot", 0.4, build)
    for _ in range(2):
        add("isdf.sweep.ao", 0.35, build)
    for _ in range(8):
        add("isdf.solve.fft", 0.5 / 8, build)
        add("isdf.solve.gram", 2.5 / 8, build)
    rec = {"spans": spans, "counts": {"scf.adiis_taken": 2}}
    return ps.digest(rec, idle={"isdf.build": (8.0, 0.8, 0.1),
                                "scf.kernel": (6.0, 2.4, 0.2)})


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_reads_its_spans(name):
    assert name in {m["name"] for m in spec_mod.per_layer_metrics(
        SPEC, "nio_dzvp_k222.job")}
    rd = spec_mod.metric_reader(name)
    d = _synthetic_record()
    assert rd.read({"probes": {name: d}}) == pytest.approx(NEW[name])
    assert rd.read({"probes": {}}) is None
    assert rd.read({"probes": {name: None}}) is None
    empty = ps.digest({"spans": [], "counts": {}})
    assert rd.read({"probes": {name: empty}}) is None


def test_digest_self_seconds():
    d = _synthetic_record()
    cyc = d["spans"]["scf.cycle"]
    assert cyc["n"] == 4 == d["cycles"]
    assert cyc["self_s"] == pytest.approx(4 * (0.25 - 0.2375))
    assert d["spans"]["scf.kernel"]["self_s"] == pytest.approx(5.0 - 1.1)
    assert d["spans"]["scf.diis"]["self_s"] == pytest.approx(4 * 0.05)
    assert d["spans"]["isdf.build"]["idle_self_s"] == 0.1
    assert d["spans"]["scf.cycle"]["idle_s"] is None


def _window_job(k, nchunks=2, traced=False):
    return {"k": k, "e_tot": -1.0 - k, "cycles": 10,
            "cycle_times": [0.1] * 10, "nchunks": nchunks, "nip": 7,
            "timings": {"solve_s": 2.0}, "traced": traced}


def _findings(draw, nchunks=2):
    """What the measuring process prints for ``draw``, through JSON."""
    rec = {"spans": [_span("scf.cycle", 0, 10**8, 0, None),
                     _span("isdf.solve.gram", 0, 10**9, 1, None)],
           "counts": {}}
    job = dict(_window_job(draw, nchunks), cycle_ms=100.0, solve_s=2.0,
               peak_bytes=0)
    return json.loads(json.dumps({"recorded": rec, "idle": None,
                                  "job": job}))


@pytest.mark.parametrize("n_window", [1, 4, 5])
def test_the_recorded_job_is_the_windows_first(monkeypatch, n_window):
    """The job read is the window's first, whatever the window's length
    and however many traced jobs follow it."""
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload",
                                      "nio_dzvp_k222.job", "--seed", "5"])
    drawn = []
    monkeypatch.setattr(ps, "_spawn", lambda args, k: drawn.append(
        (args.workload, args.seed, k)) or _findings(k))
    monkeypatch.setattr(ps, "log", lambda *a: None)
    jobs = [_window_job(k) for k in range(n_window)]
    jobs += [_window_job(n_window + i, traced=True) for i in range(2)]
    ctx = {"jobs": jobs, "device": torch.device("cpu")}
    d = ps.recorded_job(ctx)
    assert drawn == [("nio_dzvp_k222.job", 5, 0)]
    assert d["job"]["k"] == 0 and d["cycles"] == 1
    assert ps.recorded_job(ctx) is d and len(drawn) == 1


def test_another_chunking_reads_nothing(monkeypatch):
    """A recorded job whose metric pass ran in another number of chunks
    than the window's job gives None, and says so in the log."""
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload",
                                      "nio_dzvp_k222.job", "--seed", "5"])
    monkeypatch.setattr(ps, "_spawn", lambda args, k: _findings(k, 3))
    lines = []
    monkeypatch.setattr(ps, "log", lambda *a: lines.append(" ".join(a)))
    ctx = {"jobs": [_window_job(0)], "device": torch.device("cpu")}
    assert ps.recorded_job(ctx) is None
    assert any("NO READING" in ln and "3 chunk" in ln for ln in lines)


def test_the_reconciliation_is_logged(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload",
                                      "nio_dzvp_k222.job", "--seed", "5"])
    d = _synthetic_record()
    d["job"] = dict(_window_job(0), cycle_ms=300.0, solve_s=3.5,
                    peak_bytes=0)
    lines = []
    monkeypatch.setattr(ps, "log", lambda *a: lines.append(" ".join(a)))
    ps._log_reconciliation(d, _window_job(0), [_window_job(0)])
    cyc = next(ln for ln in lines if "cycle parts" in ln)
    assert "= 237.500 ms" in cyc and "remainders 62.500 / -137.500" in cyc
    sol = next(ln for ln in lines if "solve parts" in ln)
    assert "= 3.0000 s" in sol and "remainders 0.5000 / -1.0000" in sol


def test_program_without_recorder_reads_nothing(monkeypatch):
    from fftisdf_tpu_torch.utils import profiling

    monkeypatch.setattr(sys, "argv", ["benchmark/run.py", "--workload",
                                      "nio_dzvp_k222.job", "--seed", "5"])
    monkeypatch.setattr(ps, "_spawn", lambda *a: pytest.fail("launched"))
    monkeypatch.delattr(profiling, "recording")
    ctx = {"jobs": [{"k": 0}], "device": torch.device("cpu")}
    assert ps.recorded_job(ctx) is None


def test_the_run_arguments():
    a = ps._run_args(["--workload", "w.job", "--seed", "2147483653",
                      "--seconds", "51", "--trace", "1"])
    assert (a.workload, a.seed, a.control) == ("w.job", 2147483653, False)
    assert ps._run_args(["-q", "benchmark/tests"]) is None
    ctx = {"jobs": [{"k": 0}], "device": torch.device("cpu")}
    assert ps.recorded_job(ctx) is None            # pytest's command line


def test_measuring_process_needs_a_card():
    """The measuring process runs as a module of its own and, without a
    card, exits 2 with no findings: the probe reads None."""
    args = ps._run_args(["--workload", "nio_dzvp_k222.job", "--seed", "7"])
    assert ps._spawn(args, 0) is None


def test_traced_tiny_run_reads_the_program(monkeypatch):
    """A --trace 1 run of the tiny configuration on the CPU: the readers'
    probe records the window's first job again after the cell's set-up
    (in this process: the measuring process reads BENCHMARK.json, which
    has no tiny cell), the job it records is that job (its energy and
    cycles), every span reader reads a number (the idle shares need
    device events: none on the CPU), and the answer stays correct."""
    spec = spec_mod.load_spec()
    spec["configs"].append({"name": "tiny", "file": TINY})
    spec["workloads"].append({"name": "tiny.job", "config": "tiny",
                              "traffic": "job", "chips": 1})
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = m["workloads"] + ["tiny.job"]
    argv = ["--workload", "tiny.job", "--seed", "271828182845",
            "--seconds", "0.01", "--trace", "1"]
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py"] + argv)
    cpu = torch.device("cpu")
    drawn, held = [], []

    def in_process(args, draw):
        drawn.append(draw)
        out = ps.measure(spec, args.workload, args.seed, draw, cpu)
        return json.loads(json.dumps(out))

    same_job = ps._same_job
    monkeypatch.setattr(ps, "_same_job", lambda mine, first: held.append(
        (mine, first)) or same_job(mine, first))
    monkeypatch.setattr(ps, "_spawn", in_process)
    lines = []
    monkeypatch.setattr(ps, "log", lambda *a: lines.append(" ".join(a)))
    res = bench_run.run(bench_run.parse_args(argv), cpu, spec)
    assert res["correct"], res["checks"]
    assert drawn == [0]                            # once for every reader
    (mine, first), = held
    assert mine["k"] == first["k"] == 0
    assert mine["cycles"] == first["cycles"]
    assert mine["e_tot"] == pytest.approx(first["e_tot"], abs=1e-9)
    assert any("cycle parts" in ln for ln in lines)
    assert any("solve parts" in ln for ln in lines)
    got = res["metrics"]
    for name in NEW:
        if "idle" in name:
            assert name not in got
        elif name == "adiis_taken.job":
            assert 0.0 <= got[name]["value"] <= 100.0
        else:
            assert got[name]["value"] > 0, name
