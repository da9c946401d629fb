"""Device seconds per job of the program's ``isdf.select.pivot`` span (the
greedy pivoted Cholesky of selection, ``isdf/kpoint.py::_select_once``), in
the recorded job of a traced run (the window's first job run again,
harness/program_spans.py)."""
from benchmark.harness import program_spans as ps

NAME = "select_pivot_s.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.seconds(ps.probed(run, NAME), "isdf.select.pivot")
