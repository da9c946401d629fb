"""Device seconds per job of the program's ``isdf.sweep.ao`` spans (the AO
evaluation of the metric pass's grid blocks, ``isdf/kpoint.py::
_sweep_rows``), in the recorded job of a traced run (the window's first job
run again, harness/program_spans.py)."""
from benchmark.harness import program_spans as ps

NAME = "sweep_ao_s.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.seconds(ps.probed(run, NAME), "isdf.sweep.ao")
