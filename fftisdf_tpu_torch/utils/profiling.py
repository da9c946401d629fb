"""Profiling hooks: torch.profiler traces + named phases.

The port of the JAX package's ``fftisdf_tpu/utils/profiling.py``: a
profiler trace of a window and named phases with a wall-clock log line.
Usage::

    with trace("/tmp/isdf-trace"):       # a torch.profiler trace of the card
        with phase("build-y"):           # named range + wall-clock log line
            ...

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
from fftisdf_tpu_torch.utils.logging import Logger

_log = Logger(verbose=3)

# Chrome-trace categories of work that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str, *, device="cuda"):
    """Capture a ``torch.profiler`` trace of the window into
    ``<logdir>/trace.json`` and yield the profiler.

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
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    if dev.type == "cuda":
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") in DEVICE_CATEGORIES for e in events):
            raise RuntimeError(f"the trace {path} holds no device activity "
                               "(CUPTI unavailable?)")


@contextlib.contextmanager
def phase(name: str, log: Logger = None):
    """Named profiler range + wall-clock log line (ref-style timer UX).

    The range is a ``torch.profiler.record_function`` inside a
    ``torch.cuda.nvtx.range`` when CUDA is present.  Like the JAX
    package's, the phase does not synchronise the device: its wall time
    is the host's, which for asynchronous CUDA work is the time to
    enqueue it unless the body synchronises."""
    log = log or _log
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(torch.profiler.record_function(name))
        yield
    log.info("    wall time for %s: %9.3f sec", name,
             time.perf_counter() - t0)
