"""Seconds per job of the ISDF build's ``timings["solve_s"]`` (a device sync
ends each), read from the program's FFTISDF object."""
from benchmark.harness.readers import mean_timing


def read(run):
    return mean_timing(run, "solve_s")
