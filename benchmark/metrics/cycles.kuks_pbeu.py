"""SCF cycles per served job over the window: the program's ``cycles``."""
from benchmark.harness.readers import cycles as read  # noqa: F401
