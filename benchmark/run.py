"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the program (``fftisdf_tpu_torch``)
beside ``BENCHMARK.json``.  The cell's configuration, traffic mix and
per-layer metric readers are found by name from BENCHMARK.json.  The run
needs the CUDA devices the cell asks for and exits with code 2 (no
result) without them.  ``--control`` runs the program in the
configuration's control precision (float32): the check that the
comparison fails it; a benchmark run never passes it.

Standard error carries the run's log: the device, its power limit and
clocks beside the window, each job's energy and cycles, the build's
chunks and points, and, as its last lines, each compared number beside
its limit.  The last line of standard output is the result (JSON).
"""
import time

T_START = time.time()            # process start, as near as Python gets

import argparse                  # noqa: E402
import json                      # noqa: E402
import os                        # noqa: E402
import sys                       # noqa: E402
from pathlib import Path         # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
# one process with one host thread per library pool: the host's other
# cores stay free for the process's own dispatch, and spinning pools of a
# shared host's cores do not make the runs spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the program in the configuration's control "
                        "precision (the check's control; not a benchmark "
                        "run)")
    return p.parse_args(argv)


def checks(cell, ref_readings):
    """The compared numbers {name: (value, limit)}; a number with no
    reading (no job finished) is None and fails."""
    lim = cell.cfg["limits"]
    unconverged = (sum(1 for j in cell.jobs if not j["converged"])
                   + len(cell.failures))
    out = {"unconverged": (float(unconverged), float(lim["unconverged"]))}
    for key in ("energy_gap", "moment_gap"):
        vals = [r[key] for r in ref_readings]
        out[key] = (max(vals) if vals else None, float(lim[key]))
    return out


def judge_answers(cell, device):
    """The reference's readings of the run's checked answers: one
    reference state per geometry drawn, each answer judged against it
    (an answer equal to one already judged reads the same)."""
    import importlib

    import numpy as np

    from benchmark.harness.loop import log

    name = cell.mix["reference"]
    if not name.isidentifier():
        raise ValueError(f"reference {name!r} is no module name")
    Reference = importlib.import_module(f"benchmark.reference.{name}"
                                        ).Reference

    readings = []
    by_draw = {}
    for j in cell.checked_jobs():
        by_draw.setdefault(j["draw"], []).append(j)
    for group in by_draw.values():
        t0 = time.perf_counter()
        ref = Reference(cell.cfg, group[0]["geometry"], device)
        judged = []                  # (energy, density, reading)
        for j in group:
            r = next((r for e, d, r in judged if e == j["e_tot"]
                      and np.array_equal(d, j["dm"])), None)
            if r is None:
                r = ref.judge(j["e_tot"], j["dm"])
                judged.append((j["e_tot"], j["dm"], r))
            readings.append(r)
            log(f"check job {j['k']}: E_ref = {r['e_ref']:.10f} Ha "
                f"({r['ref_cycles']} reference cycles, |dE| "
                f"{r['ref_de']:.1e}, |ddm| {r['ref_ddm']:.1e}), energy gap "
                f"{r['energy_gap']:.3e} Ha/atom, moment gap "
                f"{r['moment_gap']:.3e}, moments "
                + " ".join(f"{m:+.4f}" for m in r["moments_ref"])
                + " (program "
                + " ".join(f"{m:+.4f}" for m in r["moments_program"]) + ")")
        log(f"reference for draw {group[0]['draw']}: "
            f"{time.perf_counter() - t0:.1f}s ("
            + ", ".join(f"{n} {v:.1f}s" for n, v in ref.seconds.items())
            + ")")
        del ref
    return readings


def run(args, device, spec, t_start=T_START):
    """One run of a cell on ``device``; returns the result dict (or raises).
    Tests call it with a CPU device: only :func:`main` looks for cards."""
    import torch

    from benchmark.harness import device as dev_mod, spec as spec_mod
    from benchmark.harness.loop import CellRun, log
    from benchmark.harness.tracing import breakdown

    cell = CellRun(spec, args.workload, args.seed, device,
                control=args.control)
    on_card = device.type == "cuda"
    if on_card:
        log(f"device: {torch.cuda.get_device_name(device)} x "
            f"{torch.cuda.device_count()}, power limit "
            f"{dev_mod.smi('power.limit')}")
    log(f"cell {cell.name}: config {cell.w['config']}, traffic "
        f"{cell.w['traffic']}, seed {cell.seed}, dtype {cell.dtype}")
    cell.setup()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    setup_s = time.time() - t_start
    log(f"setup: {setup_s:.3f}s")
    if on_card:
        log(f"clocks before the window: {dev_mod.smi('clocks.sm,power.draw')}")
    t_win, win_peak = cell.window(args.seconds)
    if on_card:
        log(f"clocks after the window: {dev_mod.smi('clocks.sm,power.draw')}")
    window_jobs = list(cell.jobs)
    window_spans = {k: list(v) for k, v in cell.spans.seconds.items()}
    summary = cell.traced() if args.trace else None
    run_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    jobs = cell.jobs
    for j in jobs:
        log(f"job {j['k']}: E = {j['e_tot']:.10f} Ha, {j['cycles']} cycles, "
            f"converged {j['converged']}, nip {j['nip']}, chunks "
            f"{j['nchunks']}, build {j['timings'].get('build_s', 0):.3f}s")
    log(f"window: {t_win:.3f}s, {len(window_jobs)} job(s) completed; "
        f"{len(jobs) - len(window_jobs)} traced after it; "
        f"{len(cell.failures)} failed")
    if jobs and cell.mix["geometry"] == "per_run":
        spread = max(abs(j["e_tot"] - jobs[0]["e_tot"]) for j in jobs)
        log(f"SCF energies within {spread:.2e} Ha of the first "
            f"(conv_tol {cell.conv_tol:g}): {spread <= cell.conv_tol}")

    e2e_name = cell.mix["end_to_end"]
    metrics = {}
    record = {"jobs": window_jobs,
              "traced_jobs": [j for j in jobs if j["traced"]],
              "spans": window_spans, "trace": summary, "window_s": t_win,
              "peak_window_bytes": win_peak, "probes": {}}
    if not args.trace:
        if window_jobs:
            metrics[e2e_name] = {"value": t_win / len(window_jobs),
                                 "unit": "s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        ctx = cell.context()
        readers = [(m, spec_mod.metric_reader(m["name"]))
                   for m in spec_mod.per_layer_metrics(spec, cell.name)]
        for m, rd in readers:
            if hasattr(rd, "probe"):
                record["probes"][m["name"]] = rd.probe(ctx)
        del ctx
        for m, rd in readers:
            v = rd.read(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    cell.release()

    # the reference, after the window, the peak reading and the release
    nums = checks(cell, judge_answers(cell, device))
    correct = all(v is not None and v <= lim for v, lim in nums.values())
    device_info = (dev_mod.describe(device, cell.w["chips"]) if on_card
                   else {"platform": "cpu", "kind": "cpu", "count": 1})
    device_info["memory_peak_bytes"] = int(max(setup_peak, win_peak,
                                               run_peak))
    if args.trace and summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": len(jobs) + len(cell.failures),
              "failed": int(nums["unconverged"][0]), "metrics": metrics,
              "device": device_info}
    if args.trace and summary is not None:
        result["breakdown"] = breakdown(summary)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in nums.items()}
    return result


def finish(result):
    """The guard, the compared numbers on standard error, the result
    line.  Returns the exit code."""
    from benchmark.harness.device import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv)
    from benchmark.harness import device as dev_mod, spec as spec_mod

    spec = spec_mod.load_spec()
    w = spec_mod.workload(spec, args.workload)
    try:
        device = dev_mod.require_cards(int(w["chips"]))
    except dev_mod.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    return finish(run(args, device, spec))


if __name__ == "__main__":
    sys.exit(main())
