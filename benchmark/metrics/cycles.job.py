"""SCF cycles to convergence per job over the window (``mf.cycles``)."""
from benchmark.harness.readers import cycles as read  # noqa: F401
