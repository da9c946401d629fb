"""The general generator: one closed-loop client driving the program
through a cell's traffic mix, the measured window, the traced segment
and the check.

A mix (``benchmark/traffic/<name>.json``) says what one job is:
``geometry`` "per_job" (each job a new seeded geometry, built and
solved from scratch: new cell, ISDF build, SCF set-up, SCF) or
"per_run" (set-up builds the state of one seeded geometry and makes
the SCF object; a job is one ``kernel()`` from the initial guess on it);
``scf`` the SCF class (``driver``: a class of ``fftisdf_tpu_torch.scf``) and any keyword
arguments of it beside the configuration's; ``reference`` the module of
``benchmark/reference/`` that judges the answers.  ``warm_jobs`` jobs run
in set-up, on a draw the window never uses; ``check_jobs`` ("all" or a
count drawn from the seed) of the window's jobs are held to the
reference after the window; ``end_to_end`` names the metric the window
gives (the window's seconds per completed job).  A traced run measures
the same window untraced, for the host-clock readers, then runs jobs
under the profiler for ``trace_seconds`` more, for the device readers:
the profiler stretches host time, and its own cost grows with the device
operations it records.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback

import numpy as np
import torch

from benchmark.harness import program, spec as spec_mod
from benchmark.harness.geometry import WARM_JOB, geometry
from benchmark.harness.tracing import Spans, reduce_trace, sync

# caching-allocator counters logged for the window (device mallocs and
# frees, and retries after freeing the cache, synchronise the host)
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class CellRun:
    """One run of a cell: :meth:`setup`, :meth:`window`, then
    :meth:`release` and the check of :meth:`checked_jobs` (run.py)."""

    def __init__(self, spec, name, seed, device, control=False):
        self.spec = spec
        self.name = name
        self.seed = int(seed)
        self.device = device
        self.w = spec_mod.workload(spec, name)
        self.cfg = spec_mod.load_config(spec, self.w["config"])
        self.mix = spec_mod.load_traffic(self.w["traffic"])
        prec = self.cfg["control"] if control else self.cfg
        self.dtype = program.DTYPES[prec["dtype"]]
        self.conv_tol = float(prec["conv_tol"])
        self.spans = Spans(device)
        self.jobs = []
        self.failures = []        # tracebacks of the window's failed jobs
        self.state = None         # per_run: (geometry, cell, kpts, df, mf)
        self.last = None          # the objects of the last job, for probes

    # -- one job ---------------------------------------------------------
    def _prepare(self, k, sp):
        """(geometry, cell, kpts, df, mf) of draw ``k``, spans ``sp.*``."""
        geom = geometry(self.cfg, self.seed, k)
        with self.spans(sp + ".geometry"):
            cell, kpts = program.make_cell(self.cfg, *geom)
        with self.spans(sp + ".build"):
            df = program.make_isdf(self.cfg, cell, kpts, self.dtype,
                                   self.device).build()
        with self.spans(sp + ".scf_init"):
            mf = program.make_scf(self.cfg, self.mix, cell, kpts, df,
                                  self.dtype, self.conv_tol, self.device)
        return geom, cell, kpts, df, mf

    def _job(self, k, sp):
        """Run job ``k``; its record (the answer, held to the reference
        after the window, and what the readers read)."""
        per_job = self.mix["geometry"] == "per_job"
        if per_job:
            self.last = None
            geom, cell, kpts, df, mf = self._prepare(k, sp)
        else:
            geom, cell, kpts, df, mf = self.state
        with self.spans(sp + ".scf"):
            e_tot = mf.kernel()
        rec = {"k": k, "draw": k if per_job else 0, "geometry": geom,
               "e_tot": float(e_tot),
               "dm": np.asarray(mf.dm), "converged": bool(mf.converged),
               "cycles": int(mf.cycles),
               "cycle_times": [float(t) for t in mf.cycle_times],
               "nip": int(df.nip), "timings": dict(df.timings),
               "nchunks": int(df.nchunks),
               "pool": (len(kpts), int(np.prod(df.m0)), cell.nao_nr())}
        self.last = (df, mf)
        return rec

    # -- phases ----------------------------------------------------------
    def setup(self):
        """Everything before the first timed job: the state a per_run mix
        serves, and the warm-up jobs."""
        if self.mix["geometry"] == "per_run":
            self.state = self._prepare(0, "setup")
            df = self.state[3]
            log(f"setup: build {df.timings.get('build_s', 0.0):.3f}s in "
                f"{df.nchunks} chunk(s), nip {df.nip}")

        for i in range(int(self.mix["warm_jobs"])):
            rec = self._job(WARM_JOB + i, "setup")
            log(f"setup: warm job E = {rec['e_tot']:.10f} Ha, "
                f"{rec['cycles']} cycles, converged {rec['converged']}")
        sync(self.device)

    def _run_jobs(self, seconds, sp, traced):
        """Jobs back to back until ``seconds`` have passed; every job
        started is finished and counted.  Returns the seconds taken."""
        t0 = time.perf_counter()
        k = len(self.jobs) + len(self.failures)
        while time.perf_counter() - t0 < seconds:
            try:
                rec = self._job(k, sp)
                rec["traced"] = traced
                self.jobs.append(rec)
            except Exception:                   # the job's answer is missing
                self.failures.append(traceback.format_exc())
                log(f"job {k} failed:\n{self.failures[-1]}")
                break
            k += 1
        sync(self.device)
        return time.perf_counter() - t0

    def window(self, seconds):
        """The measured window.  Returns (seconds, peak bytes)."""
        dev = self.device
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        st0 = torch.cuda.memory_stats(dev) if on_card else {}
        sp = "job" if self.mix["geometry"] == "per_job" else "serve"
        t_win = self._run_jobs(seconds, sp, traced=False)
        if on_card:
            st = torch.cuda.memory_stats(dev)
            log("allocator in the window: " + ", ".join(
                f"{k} {st.get(k, 0) - st0.get(k, 0)}" for k in ALLOC_KEYS))
        return t_win, (torch.cuda.max_memory_allocated(dev) if on_card
                       else 0)

    def traced(self):
        """Jobs under the profiler for the mix's ``trace_seconds``, after
        the window, with spans of the window's names kept apart.  Returns
        the trace summary."""
        from torch.profiler import ProfilerActivity, profile

        window_spans, self.spans = self.spans, Spans(self.device)
        on_card = self.device.type == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                   else ProfilerActivity.CPU])
        sp = "job" if self.mix["geometry"] == "per_job" else "serve"
        with prof:
            t_tr = self._run_jobs(float(self.mix["trace_seconds"]), sp,
                                  traced=True)
        t_red = time.perf_counter()
        summary = reduce_trace(prof, self.spans.intervals, t_tr)
        del prof
        self.spans = window_spans
        if summary is not None:
            log(f"trace: {summary['device_events']} device events, busy "
                f"{summary['busy_s']:.3f}s of {t_tr:.3f}s, reduced in "
                f"{time.perf_counter() - t_red:.1f}s, first device event "
                f"{summary['clock_offset_ns']} ns after the first span's "
                f"start")
        return summary

    def context(self):
        """What a reader's ``probe`` may use: the live program state."""
        df, mf = self.last if self.last else (None, None)
        return {"df": df, "mf": mf, "jobs": self.jobs, "device": self.device}

    def release(self):
        """Drop the program's state before the reference runs."""
        self.state = None
        self.last = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked_jobs(self):
        """The window's jobs held to the reference: all, or a count drawn
        from the seed (the traced segment's are not timed and not held)."""
        jobs = [j for j in self.jobs if not j["traced"]]
        n = self.mix["check_jobs"]
        if n == "all" or int(n) >= len(jobs):
            return jobs
        rng = np.random.default_rng([self.seed % 2 ** 64, 1])
        idx = sorted(rng.choice(len(jobs), size=int(n), replace=False))
        return [jobs[i] for i in idx]
