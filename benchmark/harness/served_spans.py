"""The program's own spans and counters of a served job, read in the
run's own process.

A cell whose mix builds its state once (``geometry`` "per_run") serves
every job from that state: a job is one ``kernel()`` on the SCF object
the set-up made, so its spans do not depend on the build, and a second
process that rebuilds the state (``program_spans.recorded_job``) is not
needed.  At the production size it is not possible either: the run's
process still holds the state (~40 GB) while its probes run, and a
rebuild beside it sizes its metric-pass chunks from the memory left.

The probe (:func:`served_job`, once a run: the result is kept in the
probe context that every reader's probe shares) runs ``ctx["mf"].kernel()``
once more on the run's live state under ``profiling.recording`` of the
run's device, synchronises, drains the recorder and digests the record
with ``program_spans.digest``.  It logs one line per span name, the
counters, and the cycle's parts (``CYCLE_PARTS``: device milliseconds
per cycle) beside that ``kernel()``'s own ``cycle_ms`` (host seconds per
cycle).  The run's process has run the profiler before its probes (the
traced segment comes first), and a process that has run the profiler
launches more slowly afterwards, so launch-bound spans may read up to
~30% long (PERF.md §3); the xc pass is device-bound.

The digest's ``job`` holds the served job's energy, cycles and
``cycle_ms``, and the shape (nk, ng, nao) and complex type of the xc
pass's AO tensor, for ``xc_count``.  A program without the recorder, a
context without an SCF object, or a failure give None and a line in the
log."""
from __future__ import annotations

import traceback

import numpy as np
import torch

from benchmark.harness import program_spans as ps
from benchmark.harness.loop import log
from benchmark.harness.tracing import sync

CACHE_KEY = "served_spans"
CYCLE_PARTS = ("scf.jk", "scf.xc", "scf.hubbard", "scf.diis", "scf.eigh",
               "scf.occ")
COMPLEX = {torch.float64: "complex128", torch.float32: "complex64"}


def served_job(ctx):
    """The digest of one more served job (computed once per probe
    context), or None."""
    if CACHE_KEY not in ctx:
        ctx[CACHE_KEY] = _served_job(ctx)
    return ctx[CACHE_KEY]


def _served_job(ctx):
    try:
        from fftisdf_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "recording") and hasattr(profiling, "drain")):
        return None
    mf, device = ctx.get("mf"), ctx["device"]
    if mf is None:
        log("served spans: no reading: the run holds no SCF object")
        return None
    try:
        with profiling.recording(device):
            e_tot = mf.kernel()
            sync(device)
            rec = profiling.drain()
    except Exception:                           # the reading is missing
        log(f"served spans: no reading:\n{traceback.format_exc()}")
        return None
    times = list(mf.cycle_times)
    fmesh = getattr(mf, "_fmesh", None)
    job = {"e_tot": float(e_tot), "cycles": int(mf.cycles),
           "cycle_ms": 1e3 * sum(times) / len(times) if times else None,
           "xc_shape": ((len(mf.kpts), int(np.prod(fmesh)),
                         int(mf.h1e.shape[-1])) if fmesh else None),
           "complex": COMPLEX.get(mf.dtype)}
    d = ps.digest(rec, None, job)
    log(f"served spans: kernel() on the run's state: E = {e_tot:.10f} Ha, "
        f"{job['cycles']} cycles")
    ps.log_table(d)
    _log_parts(d)
    return d


def _log_parts(d):
    """The cycle's parts beside the served job's host ``cycle_ms``."""
    parts = {s: ps.ms_per_cycle(d, s) for s in CYCLE_PARTS}
    have = {s: v for s, v in parts.items() if v is not None}
    cyc = d["job"]["cycle_ms"]
    if not have or not cyc:
        return
    s = sum(have.values())
    log("served spans: cycle parts " + " + ".join(
        f"{k} {v:.3f}" for k, v in have.items()) + f" = {s:.3f} ms; cycle "
        f"(host) {cyc:.3f} ms; remainder {cyc - s:.3f} ms "
        f"({100.0 * (s - cyc) / cyc:+.1f}%)")
