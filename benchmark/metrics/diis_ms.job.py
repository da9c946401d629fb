"""Device milliseconds per SCF cycle of the program's ``scf.diis`` span
(the ring buffer, CDIIS and ADIIS's 400 mirror-descent steps in
``scf/device.py::_diis_update``), over the cycles of the recorded job of a
traced run (the window's first job run again, harness/program_spans.py)."""
from benchmark.harness import program_spans as ps

NAME = "diis_ms.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.ms_per_cycle(ps.probed(run, NAME), "scf.diis")
