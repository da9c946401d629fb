"""Device milliseconds per SCF cycle of the program's ``scf.eigh`` span
(the batched eigensolve of both spins at every k-point, 128 of order 62
at 4x4x4) in one more served job on the run's own state, after its
traced segment (harness/served_spans.py)."""
from benchmark.harness import program_spans as ps
from benchmark.harness import served_spans as ss

NAME = "eigh_ms.kuks_pbeu"


def probe(ctx):
    return ss.served_job(ctx)


def read(run):
    return ps.ms_per_cycle(ps.probed(run, NAME), "scf.eigh")
