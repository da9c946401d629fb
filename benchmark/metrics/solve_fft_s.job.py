"""Device seconds per job of the program's ``isdf.solve.fft`` spans (the
e^{-iqr} phase, the FFT slabs and the kernel scaling of every sector,
``isdf/kpoint.py::_sector_wq``), in the recorded job of a traced run (the
window's first job run again, harness/program_spans.py)."""
from benchmark.harness import program_spans as ps

NAME = "solve_fft_s.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.seconds(ps.probed(run, NAME), "isdf.solve.fft")
