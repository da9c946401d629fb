"""The benchmark's own spans and the reduction of a profiler trace.

Spans are recorded from the benchmark's files around its calls into the
program (no span sits inside the program): host-clock intervals, each
ended by a device sync, kept in memory with their wall-clock (Unix
epoch) nanoseconds, the clock of the profiler's events.

The traced run profiles the device alone (CUPTI; no host operators are
recorded, which keeps the profiler's cost on the host small).  The
reduction reads the profiler's events in memory (no trace file is
written): the device's busy time as the union of its activity (a frozen
copy of ``chip_smoke.py``'s phase 13b arithmetic), device time by kernel
name, and the idle gaps labelled by the innermost benchmark span that was
open on the host at the gap's middle."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

MIN_GAP_NS = 20_000          # idle gaps shorter than this are not labelled


class Spans:
    """Host-clock spans by name: ``with spans("job.build"): ...``; the
    device is synchronised at each span's end, so the span holds its
    device work."""

    def __init__(self, device):
        self.device = device
        self.seconds = defaultdict(list)
        self.intervals = []          # (start ns, end ns, name), wall clock

    @contextlib.contextmanager
    def __call__(self, name):
        w0, t0 = time.time_ns(), time.perf_counter()
        yield
        sync(self.device)
        self.seconds[name].append(time.perf_counter() - t0)
        self.intervals.append((w0, time.time_ns(), name))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    busy, gaps = 0, []
    end = None
    for s0, s1 in sorted(intervals):
        if end is None:
            busy += s1 - s0
            end = s1
        elif s1 > end:
            if s0 > end:
                gaps.append((end, s0))
            busy += s1 - max(s0, end)
            end = s1
    return busy, gaps


def reduce_trace(prof, spans, t_window):
    """Summary of a profiler run over the measured window.

    ``spans``: the benchmark's (start ns, end ns, name) intervals, which
    label idle gaps; ``t_window`` (seconds): the host-clock window.
    Returns a dict: busy_s, window_s, device time by name {name: [s, n]},
    idle seconds by label, the device event count, and the offset of the
    first device event from the first span (ns; a check that the two
    clocks agree)."""
    events = prof.profiler.kineto_results.events()
    dev = []
    for e in events:
        # kernels, copies and sets; a user annotation's device-side range
        # is no operation (none is recorded: no host activity is traced)
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            dev.append((e.name(), e.start_ns(), e.start_ns()
                        + e.duration_ns()))
    if not dev:
        return None
    spans = sorted(spans)
    busy, gaps = _union([(s0, s1) for _, s0, s1 in dev])
    by_name = defaultdict(lambda: [0.0, 0])
    for name, s0, s1 in dev:
        by_name[name][0] += (s1 - s0) * 1e-9
        by_name[name][1] += 1
    idle = defaultdict(float)
    for g0, g1 in gaps:
        if g1 - g0 < MIN_GAP_NS:
            idle["(gaps under 20 us)"] += (g1 - g0) * 1e-9
            continue
        mid = 0.5 * (g0 + g1)
        # innermost (latest-starting) span open at the middle of the gap
        label = "(outside the benchmark's spans)"
        for s0, s1, name in spans:
            if s0 > mid:
                break
            if s1 >= mid:
                label = name
        idle[label] += (g1 - g0) * 1e-9
    return {"busy_s": busy * 1e-9, "window_s": float(t_window),
            "by_name": dict(by_name), "idle_by_label": dict(idle),
            "device_events": len(dev),
            "clock_offset_ns": (min(s0 for _, s0, _ in dev) - spans[0][0]
                                if spans else None)}


def breakdown(summary, top=10):
    """The result line's ``breakdown``: the device operations that took
    most time and the idle time by what the host was doing."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(summary["idle_by_label"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, v[0]] for n, v in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
