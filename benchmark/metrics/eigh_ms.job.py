"""Device milliseconds per SCF cycle of the program's ``scf.eigh`` span
(the orthogonal transform and the batched ``torch.linalg.eigh`` in
``scf/device.py``), over the cycles of the recorded job of a traced run
(the window's first job run again, harness/program_spans.py)."""
from benchmark.harness import program_spans as ps

NAME = "eigh_ms.job"


def probe(ctx):
    return ps.recorded_job(ctx)


def read(run):
    return ps.ms_per_cycle(ps.probed(run, NAME), "scf.eigh")
