"""Milliseconds per SCF cycle of the device loop (scf/device.py), over
every cycle of the window: the program's ``cycle_times``."""
from benchmark.harness.readers import cycle_ms as read  # noqa: F401
