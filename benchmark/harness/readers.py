"""Shared arithmetic of the per-layer metric readers.  A reader is
``benchmark/metrics/<name>.py`` with ``read(run) -> float | None`` (and
optionally ``probe(ctx)``, run after the window with the program's live
state, whose return value ``read`` finds in ``run["probes"][<name>]``).
``run`` holds the window's job records (``jobs``, untraced: the
host-clock readers read these), the traced segment's (``traced_jobs``),
the benchmark's span seconds in the window, the trace summary (None in
an untraced run), the window's seconds and its peak bytes.  A reader that finds nothing to read returns None."""
from __future__ import annotations

from benchmark.harness.roofline import k1_bound

# kernel K1's device function names by element type (ops/csrc/pair_gram.cu)
K1_KERNELS = {"pair_gram_z_kernel": "complex128",
              "pair_gram_c_kernel": "complex64"}


def mean_timing(run, key):
    """Mean over the window's jobs of the ISDF build's ``timings[key]``."""
    vals = [j["timings"][key] for j in run["jobs"] if key in j["timings"]]
    return sum(vals) / len(vals) if vals else None


def mean_span(run, name):
    """Mean seconds of the benchmark's span ``name`` (set-up's spans are
    named ``setup.*``, so these are the window's)."""
    vals = run["spans"].get(name, [])
    return sum(vals) / len(vals) if vals else None


def cycle_ms(run):
    """Milliseconds per SCF cycle over every cycle of the window."""
    n = sum(j["cycles"] for j in run["jobs"])
    t = sum(sum(j["cycle_times"]) for j in run["jobs"])
    return 1e3 * t / n if n else None


def cycles(run):
    """SCF cycles per job over the window."""
    jobs = run["jobs"]
    return sum(j["cycles"] for j in jobs) / len(jobs) if jobs else None


def idle_share(run):
    """Per cent of the traced window in which no operation ran on the
    device."""
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gb(run):
    b = run["peak_window_bytes"]
    return b / 1e9 if b else None


def k1_roofline(run):
    """Per cent of K1's bound that its launches in the traced segment
    reached: the sum of each launch's bound over the sum of its device
    time.  The launches are matched to the segment's builds, one selection pool
    (nk, ng, nao) each; where the counts differ nothing is read."""
    tr = run["trace"]
    if not tr:
        return None
    t_kernel, launches, dname = 0.0, 0, None
    for name, (sec, n) in tr["by_name"].items():
        for kname, dt in K1_KERNELS.items():
            if kname in name:
                t_kernel += sec
                launches += n
                dname = dt
    pools = [j["pool"] for j in run["traced_jobs"]]
    if not launches or launches != len(pools) or t_kernel <= 0:
        return None
    bound = sum(k1_bound(p, dname)[1] for p in pools)
    return 100.0 * bound / t_kernel
