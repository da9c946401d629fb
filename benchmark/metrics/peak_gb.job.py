"""Peak device memory over the window (GB): max_memory_allocated after
a reset at the window's start."""
from benchmark.harness.readers import peak_gb as read  # noqa: F401
