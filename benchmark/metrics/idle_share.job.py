"""Per cent of the traced segment in which the device ran no operation:
1 - (union of device activity) / window."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
