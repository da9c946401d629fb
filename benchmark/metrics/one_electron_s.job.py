"""Seconds of the one-electron set-up (the SCF constructor: overlap,
kinetic, pseudopotential; scf/integrals.py, basis/eval.py) per job: the
benchmark's span around it, ended by a device sync."""
from benchmark.harness.readers import mean_span


def read(run):
    return mean_span(run, "job.scf_init")
