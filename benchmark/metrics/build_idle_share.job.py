"""Per cent of the time inside the program's ``isdf.build`` span in which
the device ran nothing (gaps of every length), in the profiled job of a
traced run (the window's first job run again, harness/program_spans.py)."""
from benchmark.harness import program_spans as ps

NAME = "build_idle_share.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.idle_share(ps.probed(run, NAME), "isdf.build")
