"""Device milliseconds per SCF cycle of the program's ``scf.hubbard``
span (Dudarev's +U, ``scf/hubbard.py::eu_and_vu_traced``) in one more
served job on the run's own state, after its traced segment
(harness/served_spans.py)."""
from benchmark.harness import program_spans as ps
from benchmark.harness import served_spans as ss

NAME = "hubbard_ms.kuks_pbeu"


def probe(ctx):
    return ss.served_job(ctx)


def read(run):
    return ps.ms_per_cycle(ps.probed(run, NAME), "scf.hubbard")
