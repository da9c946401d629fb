"""Profiling hooks: one span recorder and torch.profiler traces.

The port of the JAX package's ``fftisdf_tpu/utils/profiling.py``, with
the JAX package's named phase grown into a recorder of spans and
counters that the program carries through the ISDF build and the device
SCF cycle.  Usage::

    with recording():                      # switch the recorder on
        with span("isdf.build"):           # a named span
            count("scf.adiis_taken")       # a counter
        ...
        torch.cuda.synchronize()
        rec = drain()                      # {"spans": [...], "counts": {...}}

    with trace("/tmp/isdf-trace"):         # a torch.profiler trace of the
        ...                                # card, spans recorded in it

Off (the default) a span is one shared null context and a counter
returns at once: no event, no profiler range, no log line, no
allocation.  On, each span keeps its name, the span it opened in, and
its host start and end from ``time.time_ns()`` (the Unix-epoch clock of
the profiler's device events), opens a ``torch.profiler.record_function``
range, and on a CUDA device records a ``torch.cuda.Event`` pair on the
current stream without synchronising.  :func:`drain` resolves the events
after the caller's own synchronise (it waits on each end event, which is
then free) and returns plain records; on the CPU the device seconds are
the host seconds.  Spans close in order; a span's self time is its
device seconds less its children's.

The trace is a Chrome trace (``<logdir>/trace.json``, readable by
chrome://tracing or Perfetto).  On the card it must hold the device's
kernels, which CUPTI records: where CUPTI is missing, :func:`trace` raises
instead of returning a trace of the host alone.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from fftisdf_tpu_torch.utils.device import resolve_device

# Chrome-trace categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "trace.json"

_NULL = contextlib.nullcontext()


class _Record:
    """One span while it is open and until it is resolved."""

    __slots__ = ("name", "parent", "seq", "parent_seq", "t0_ns", "t1_ns",
                 "ev0", "ev1", "device_s")

    def as_dict(self):
        return {"name": self.name, "parent": self.parent, "seq": self.seq,
                "parent_seq": self.parent_seq, "t0_ns": self.t0_ns,
                "t1_ns": self.t1_ns,
                "host_s": (self.t1_ns - self.t0_ns) * 1e-9,
                "device_s": self.device_s}


class _Recorder:
    """The process's recorder: on while any :func:`recording` is open."""

    def __init__(self):
        self.depth = 0            # open recording() contexts
        self.device = None        # the CUDA device of the events, or None
        self.stack = []           # open spans
        self.closed = []          # closed spans since the last drain()
        self.views = []           # open Recording views
        self.counts = {}
        self.seq = 0

    @staticmethod
    def resolve(records):
        """Device seconds of closed ``records`` (their events dropped)."""
        for r in records:
            if r.device_s is not None:
                continue
            if r.ev1 is None:
                r.device_s = (r.t1_ns - r.t0_ns) * 1e-9
            else:
                r.ev1.synchronize()
                r.device_s = r.ev0.elapsed_time(r.ev1) * 1e-3
            r.ev0 = r.ev1 = None


_REC = _Recorder()


class _Span:
    """A span while the recorder is on."""

    __slots__ = ("rec", "log", "rf")

    def __init__(self, name, log):
        r = _REC
        rec = self.rec = _Record()
        parent = r.stack[-1] if r.stack else None
        rec.name = name
        rec.parent = parent.name if parent else None
        rec.parent_seq = parent.seq if parent else None
        rec.seq = r.seq
        r.seq += 1
        rec.ev0 = rec.ev1 = rec.device_s = None
        self.log = log

    def __enter__(self):
        r = _REC
        rec = self.rec
        rec.t0_ns = time.time_ns()
        if r.device is not None:
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record(torch.cuda.current_stream(r.device))
        self.rf = torch.profiler.record_function(rec.name)
        self.rf.__enter__()
        r.stack.append(rec)
        return self

    def __exit__(self, *exc):
        r = _REC
        rec = self.rec
        self.rf.__exit__(*exc)
        r.stack.pop()
        if r.device is not None:
            rec.ev1 = torch.cuda.Event(enable_timing=True)
            rec.ev1.record(torch.cuda.current_stream(r.device))
        rec.t1_ns = time.time_ns()
        r.closed.append(rec)
        for v in r.views:
            v.records.append(rec)
        if self.log is not None:
            self.log.info("    wall time for %s: %9.3f sec", rec.name,
                          (rec.t1_ns - rec.t0_ns) * 1e-9)
        return False


@contextlib.contextmanager
def _timed(name, log):
    """The log line of a span while the recorder is off."""
    t0 = time.perf_counter()
    yield
    log.info("    wall time for %s: %9.3f sec", name,
             time.perf_counter() - t0)


def span(name: str, log=None):
    """A named span (context manager): recorded while :func:`recording`
    is on, nothing while it is off.  ``log`` (a ``Logger``): a wall-clock
    line at the span's end, on or off.  The span does not synchronise the
    device: its host times are the host's, its device seconds (on) are
    those of its CUDA events."""
    if _REC.depth:
        return _Span(name, log)
    if log is not None:
        return _timed(name, log)
    return _NULL


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if _REC.depth:
        _REC.counts[name] = _REC.counts.get(name, 0) + n


class Recording:
    """What :func:`recording` yields: the spans closed while it was open
    (a build reads its own stage spans here without draining the
    recorder)."""

    def __init__(self):
        self.records = []

    def spans(self):
        """The spans closed inside this recording, resolved, as
        :func:`drain` returns them."""
        _REC.resolve(self.records)
        return [r.as_dict() for r in self.records]


@contextlib.contextmanager
def recording(device=None):
    """Switch the recorder on for the body; yields a :class:`Recording`.

    ``device``: where the spans' CUDA events are recorded (None: the
    current CUDA device when CUDA is available, else the host clock
    alone); a nested recording keeps the outer one's.  Records stay in
    the recorder until :func:`drain`, which the caller runs inside the
    outermost recording: its end drops what was not drained."""
    r = _REC
    view = Recording()
    if not r.depth:
        dev = (resolve_device(device) if device is not None
               else resolve_device("cuda") if torch.cuda.is_available()
               else torch.device("cpu"))
        r.device = dev if dev.type == "cuda" else None
    r.depth += 1
    r.views.append(view)
    try:
        yield view
    finally:
        r.views.remove(view)
        r.depth -= 1
        if not r.depth:
            r.closed, r.counts, r.stack = [], {}, []


def drain():
    """The closed spans (in closing order) and the counter totals since
    the last drain, and clear them: ``{"spans": [{name, parent, seq,
    parent_seq, t0_ns, t1_ns, host_s, device_s}], "counts": {name: n}}``.
    Open spans stay open."""
    r = _REC
    closed, r.closed = r.closed, []
    r.resolve(closed)
    counts, r.counts = r.counts, {}
    return {"spans": [rec.as_dict() for rec in closed], "counts": counts}


@contextlib.contextmanager
def trace(logdir: str, *, device="cuda"):
    """Capture a ``torch.profiler`` trace of the window into
    ``<logdir>/trace.json`` and yield the profiler; the recorder is on
    inside it, so the trace holds the program's spans as ranges (and
    :func:`drain` inside it returns them).

    ``device="cuda"`` (the default) records the host and the card, and
    raises ``RuntimeError`` when CUDA is absent, when this torch has no
    CUDA profiling, or when the finished trace holds no device activity
    (CUPTI unavailable): a trace of the host alone is never returned in
    its place.  ``device="cpu"`` records the host only."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("this torch build cannot profile CUDA")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    with recording(dev), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    if dev.type == "cuda":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") in DEVICE_CATEGORIES for e in events):
            raise RuntimeError(f"the trace {path} holds no device activity "
                               "(CUPTI unavailable?)")
