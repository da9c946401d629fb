"""Host seconds per job of the program's ``scf.finish`` span (the f64
energy and orbitals recomputed on the host after the device loop,
``scf/device.py``), in the recorded job of a traced run (the window's first
job run again, harness/program_spans.py)."""
from benchmark.harness import program_spans as ps

NAME = "scf_finish_s.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.seconds(ps.probed(run, NAME), "scf.finish", "host_s")
