"""Per cent of the ADIIS solves that the SCF cycle took: the program's
counter ``scf.adiis_taken`` over the number of ``scf.adiis`` spans (the
cycles that computed ADIIS, ``scf/device.py``), in the recorded job of a
traced run (harness/program_spans.py).  The yield of the ADIIS work:
a solve that is not taken is 400 mirror-descent steps spent for
nothing, so skipping the solves that would not be taken raises it."""
from benchmark.harness import program_spans as ps

NAME = "adiis_taken.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.taken_share(ps.probed(run, NAME), "scf.adiis_taken",
                          "scf.adiis")
