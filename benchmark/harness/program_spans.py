"""The program's own spans and counters (``fftisdf_tpu_torch.utils.
profiling``), read in a traced run after its traced segment.

The loop (``loop.py``) records spans from outside the program only.  A
reader of a program span takes its number from :func:`recorded_job`
through its ``probe``, once a run (the result is kept in the probe
context that every reader's probe shares).  It reads one job whose
geometry the seed alone fixes, whatever the window's length: the
window's first job (draw ``jobs[0]["k"]``, the first draw after the
warm one), so both sides of a comparison on one seed read the same job.
That job runs again in a process of its own,

    python3 -m benchmark.harness.program_spans --workload <cell>
        --seed <n> --draw <k> [--control]

which runs the cell's set-up (its warm job, as the run did), then the
job twice: recorded (the spans' device seconds from CUDA events with no
added sync, the counters), then, on the card, recorded under the
profiler (device activity only) for the idle time inside each span.  It
prints its findings as the last line of standard output.  A process of
its own, because a process that has run the profiler launches more
slowly afterwards (the launch-bound SCF cycle by ~30% on the H100), and
the run's traced segment has; the run's process releases its cached
device memory first and waits.

The run's process holds the recorded job to the window's own job of the
same draw: a metric pass in another number of chunks (the chunks are
sized from free memory) gives None, and the log gets the energies, the
cycles, the peak memory, and each span sum beside the seconds it is a
part of (the cycle's parts beside the cycle's host seconds in both
processes, the solve's beside ``solve_s``).

A program without the recorder (``recording``/``drain``), a run not
started from the command line (the probe context names no cell and no
seed: the run's arguments are read from ``sys.argv`` until ``loop.py``
passes them), or a failure give None and a line in the log.

The digest (:func:`digest`): ``spans`` {name: {n, host_s, device_s,
self_s, idle_s, idle_self_s}} (sums over the recorded job; self: less
the children's device seconds; idle: seconds inside the spans in which
the device ran nothing, gaps of every length, and idle self: the idle
gaps whose innermost open span it is, both of the profiled job),
``counts`` {name: total}, ``cycles`` (``scf.cycle`` spans), ``traced``
{name: {span_s, idle_s}} of the profiled job, and ``job``, the recorded
job's summary.  On the CPU there is no profiled job: the idle columns
and ``traced`` are empty."""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

from benchmark.harness.loop import CellRun, log
from benchmark.harness.readers import cycle_ms
from benchmark.harness.spec import ROOT
from benchmark.harness.tracing import sync

CACHE_KEY = "program_spans"
SPAWN_TIMEOUT_S = 400


def device_events(prof):
    """(start ns, end ns) of the device's operations in a profiler run:
    the filter of ``tracing.reduce_trace``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            t0 = e.start_ns()
            out.append((t0, t0 + e.duration_ns()))
    return out


def idle_in_spans(spans, events):
    """Idle seconds by span name: {name: (span seconds, idle seconds
    inside the spans, idle seconds whose innermost open span it is)}.

    ``spans``: records with ``name``, ``t0_ns``, ``t1_ns`` (properly
    nested); ``events``: (start ns, end ns) of device activity.  Idle is
    the part of a span's host interval that the union of device activity
    leaves free, gaps of every length; each gap is put down to the
    innermost span open at its middle."""
    busy = _merge(events)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    starts = [b[0] for b in busy]
    cum = [0]
    for b0, b1 in busy:
        cum.append(cum[-1] + (b1 - b0))

    def busy_before(t):
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0
        b0, b1 = busy[i - 1]
        return cum[i - 1] + (min(t, b1) - b0)

    out = defaultdict(lambda: [0.0, 0.0, 0.0])
    for s in spans:
        length = s["t1_ns"] - s["t0_ns"]
        inside = busy_before(s["t1_ns"]) - busy_before(s["t0_ns"])
        out[s["name"]][0] += length * 1e-9
        out[s["name"]][1] += (length - inside) * 1e-9
    # innermost open span at each gap's middle: a sweep over the span
    # boundaries (spans nest, so the open ones form a stack)
    marks = sorted([(s["t0_ns"], 1, -s["t1_ns"], s["name"]) for s in spans]
                   + [(s["t1_ns"], 0, 0, s["name"]) for s in spans])
    stack, j = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while j < len(marks) and marks[j][0] <= mid:
            if marks[j][1]:
                stack.append(marks[j][3])
            elif stack:
                stack.pop()
            j += 1
        if stack:
            out[stack[-1]][2] += (g1 - g0) * 1e-9
    return {k: tuple(v) for k, v in out.items()}


def _merge(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for s0, s1 in sorted(intervals):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return [tuple(v) for v in out]


def digest(rec, idle=None, job=None):
    """What the readers read, from a drained recording ``rec`` (``{"spans":
    [...], "counts": {...}}``), optionally the profiled job's
    :func:`idle_in_spans` ``idle`` and the recorded job's summary
    ``job``."""
    spans = rec["spans"]
    table = defaultdict(lambda: dict(n=0, host_s=0.0, device_s=0.0,
                                     self_s=0.0, idle_s=None,
                                     idle_self_s=None))
    by_seq = {s["seq"]: s for s in spans}
    for s in spans:
        row = table[s["name"]]
        row["n"] += 1
        row["host_s"] += s["host_s"]
        row["device_s"] += s["device_s"]
        row["self_s"] += s["device_s"]
        if s["parent_seq"] in by_seq:
            table[by_seq[s["parent_seq"]]["name"]]["self_s"] -= s["device_s"]
    out = {"spans": {k: dict(v) for k, v in table.items()},
           "counts": dict(rec["counts"]),
           "cycles": table["scf.cycle"]["n"] if "scf.cycle" in table else 0,
           "traced": {}, "job": job}
    for name, (span_s, idle_s, idle_self) in (idle or {}).items():
        out["traced"][name] = {"span_s": span_s, "idle_s": idle_s}
        if name in out["spans"]:
            out["spans"][name]["idle_s"] = idle_s
            out["spans"][name]["idle_self_s"] = idle_self
    return out


def log_table(d):
    """One line per span name: count, host s, device s, self s, and of the
    profiled job: span s, idle s (inside the spans), idle self s (gaps put
    down to the span)."""
    log("program spans of the recorded job (n, host s, device s, self s; "
        "profiled job: span s, idle s, idle self s):")
    fmt = lambda v: "-" if v is None else f"{v:.6f}"
    for name in sorted(d["spans"]):
        r = d["spans"][name]
        t = d["traced"].get(name, {}).get("span_s")
        log(f"  {name:<20} {r['n']:5d} {r['host_s']:11.6f} "
            f"{r['device_s']:11.6f} {r['self_s']:11.6f} {fmt(t):>11} "
            f"{fmt(r['idle_s']):>11} {fmt(r['idle_self_s']):>11}")
    log("program counters: " + ", ".join(
        f"{k} {v}" for k, v in sorted(d["counts"].items())))


def _summary(job, peak_bytes):
    """What the run's process checks and logs of the recorded job."""
    return {"k": job["k"], "e_tot": job["e_tot"], "cycles": job["cycles"],
            "cycle_ms": cycle_ms({"jobs": [job]}), "nchunks": job["nchunks"],
            "nip": job["nip"], "solve_s": job["timings"].get("solve_s"),
            "peak_bytes": peak_bytes}


def measure(spec, workload, seed, draw, device, control=False):
    """Job ``draw`` of a run of ``workload`` with ``seed``, after the
    cell's set-up: recorded, then on the card recorded once more under
    the profiler.  Returns {"recorded": drained recording, "idle":
    :func:`idle_in_spans` of the profiled job or None, "job": summary}."""
    from fftisdf_tpu_torch.utils import profiling

    on_card = device.type == "cuda"
    cell = CellRun(spec, workload, seed, device, control=control)
    t0 = time.perf_counter()
    cell.setup()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t1 = time.perf_counter()
    with profiling.recording(device):
        job = cell._job(draw, "job")
        sync(device)
        rec = profiling.drain()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    t2 = time.perf_counter()
    idle = None
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.recording(device):
                cell._job(draw, "job")
                sync(device)
                rec_p = profiling.drain()
        events = device_events(prof)
        del prof
        _log_offset(rec_p, events)
        idle = idle_in_spans(rec_p["spans"], events)
    log(f"program spans: set-up {t1 - t0:.1f}s, recorded job "
        f"{t2 - t1:.1f}s, profiled job {time.perf_counter() - t2:.1f}s")
    return {"recorded": rec, "idle": idle, "job": _summary(job, peak)}


def _run_args(argv=None):
    """The workload, seed and control flag of the benchmark run this
    process is (its command line), or None."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--control", action="store_true")
    args, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return args if args.workload and args.seed is not None else None


def _spawn(args, draw):
    """Run the measuring process (module docstring) to its end; its
    findings, or None if it failed."""
    cmd = [sys.executable, "-m", "benchmark.harness.program_spans",
           "--workload", args.workload, "--seed", str(args.seed),
           "--draw", str(draw)]
    if args.control:
        cmd.append("--control")
    proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        log(f"program spans: the measuring process exited "
            f"{proc.returncode}")
        return None
    return json.loads(lines[-1])


def recorded_job(ctx):
    """The digest of the recorded job (computed once per probe context),
    or None."""
    if CACHE_KEY not in ctx:
        ctx[CACHE_KEY] = _recorded_job(ctx)
    return ctx[CACHE_KEY]


def _recorded_job(ctx):
    try:
        from fftisdf_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "recording") and hasattr(profiling, "drain")):
        return None
    args = _run_args()
    window = [j for j in ctx.get("jobs") or () if not j.get("traced")]
    if args is None:
        log("program spans: no reading: the command line names no "
            "workload and seed")
        return None
    if not window:
        log("program spans: no reading: the window finished no job")
        return None
    first = window[0]
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    try:
        out = _spawn(args, first["k"])
    except (OSError, ValueError, subprocess.SubprocessError) as exc:
        log(f"program spans: no reading: {exc!r}")
        return None
    if out is None:
        return None
    d = digest(out["recorded"], out["idle"], out["job"])
    log_table(d)
    if not _same_job(d["job"], first):
        return None
    _log_reconciliation(d, first, window)
    return d


def _same_job(mine, first):
    """Whether the recorded job is the window's job of the same draw as
    far as the readers go: the same number of metric-pass chunks."""
    log(f"program spans: recorded job {mine['k']}: E = {mine['e_tot']:.10f}"
        f" Ha, {mine['cycles']} cycles, {mine['nchunks']} chunk(s), peak "
        f"{mine['peak_bytes'] / 1e9:.2f} GB; the window's: E = "
        f"{first['e_tot']:.10f} Ha, {first['cycles']} cycles, "
        f"{first['nchunks']} chunk(s); |dE| "
        f"{abs(mine['e_tot'] - first['e_tot']):.1e} Ha")
    if mine["nchunks"] != first["nchunks"]:
        log(f"program spans: NO READING: the recorded job's metric pass ran "
            f"in {mine['nchunks']} chunk(s), the window's job's in "
            f"{first['nchunks']}")
        return False
    return True


def _log_reconciliation(d, first, window):
    """Each span sum beside the host seconds it is a part of."""
    parts = [ms_per_cycle(d, s) for s in CYCLE_PARTS]
    if None not in parts and d["job"]["cycle_ms"]:
        s = sum(parts)
        mine, own, win = (d["job"]["cycle_ms"], cycle_ms({"jobs": [first]}),
                          cycle_ms({"jobs": window}))
        terms = " + ".join(f"{p:.3f}" for p in parts)
        log(f"program spans: cycle parts {terms} = {s:.3f} ms; cycle "
            f"(host) {mine:.3f} ms recorded, "
            f"{own:.3f} ms the window's job, {win:.3f} ms the window "
            f"(cycle_ms); remainders {mine - s:.3f} / {own - s:.3f} / "
            f"{win - s:.3f} ms")
    fft, gram = seconds(d, "isdf.solve.fft"), seconds(d, "isdf.solve.gram")
    solve = [j["timings"].get("solve_s") for j in window]
    if fft is not None and gram is not None and d["job"]["solve_s"] \
            and None not in solve:
        win = sum(solve) / len(solve)
        log(f"program spans: solve parts {fft:.4f} + {gram:.4f} = "
            f"{fft + gram:.4f} s; solve_s {d['job']['solve_s']:.4f} s "
            f"recorded, {first['timings']['solve_s']:.4f} s the window's "
            f"job, {win:.4f} s the window; remainders "
            f"{d['job']['solve_s'] - fft - gram:.4f} / "
            f"{first['timings']['solve_s'] - fft - gram:.4f} / "
            f"{win - fft - gram:.4f} s")


def _log_offset(rec, events):
    if events and rec["spans"]:
        off = (min(e[0] for e in events)
               - min(s["t0_ns"] for s in rec["spans"]))
        log(f"program spans: first device event {off} ns after the first "
            f"program span ({len(events)} device events in the profiled "
            "job)")


def main(argv=None):
    """The measuring process: its findings as the last line of standard
    output."""
    from benchmark.harness import device as dev_mod, spec as spec_mod

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--draw", type=int, required=True)
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    spec = spec_mod.load_spec()
    w = spec_mod.workload(spec, a.workload)
    try:
        device = dev_mod.require_cards(int(w["chips"]))
    except dev_mod.NoCard as exc:
        log(f"program spans: {exc}")
        return 2
    out = measure(spec, a.workload, a.seed, a.draw, device, a.control)
    print(json.dumps(out), flush=True)
    return 0


# -- the readers' arithmetic (None where the spans are absent) -----------
CYCLE_PARTS = ("scf.jk", "scf.diis", "scf.eigh", "scf.occ")


def probed(run, name):
    """The digest a reader's probe stored under its metric ``name``."""
    return (run.get("probes") or {}).get(name)


def ms_per_cycle(d, span):
    """Device milliseconds of ``span`` per SCF cycle."""
    if not d or not d["cycles"] or span not in d["spans"]:
        return None
    return 1e3 * d["spans"][span]["device_s"] / d["cycles"]


def seconds(d, span, key="device_s"):
    """Seconds of ``span`` in the job (device or host)."""
    if not d or span not in d["spans"]:
        return None
    return d["spans"][span][key]


def taken_share(d, counter, span):
    """Per cent of the ``span``s that counter ``counter`` counts."""
    if not d or counter not in d["counts"] or span not in d["spans"] \
            or not d["spans"][span]["n"]:
        return None
    return 100.0 * d["counts"][counter] / d["spans"][span]["n"]


def idle_share(d, span):
    """Per cent of the profiled job's time inside ``span`` in which the
    device ran nothing."""
    if not d or span not in d["traced"] or d["traced"][span]["span_s"] <= 0:
        return None
    t = d["traced"][span]
    return 100.0 * t["idle_s"] / t["span_s"]


if __name__ == "__main__":
    sys.exit(main())
