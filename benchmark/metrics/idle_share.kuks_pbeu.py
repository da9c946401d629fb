"""Per cent of the traced segment (served jobs under the profiler) in
which no operation ran on the device."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
