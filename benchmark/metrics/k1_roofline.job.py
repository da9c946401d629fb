"""Kernel K1's share of its roofline over the traced segment's builds: device
time by kernel name from the trace, the bound from each launch's
selection pool (benchmark/harness/roofline.py)."""
from benchmark.harness.readers import k1_roofline as read  # noqa: F401
