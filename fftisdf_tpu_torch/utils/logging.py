"""Minimal leveled logger.

The port's copy of the JAX package's ``fftisdf_tpu/utils/logging.py``
without its timer (wall-clock lines are ``utils.profiling.span(log=)``'s).
Keeps the reference's observability UX: per-phase lines and resource
estimates (``fftisdf.py:56-69,89,122``) without external deps.
Levels follow the reference's verbose convention (0 quiet, 3 info, 5 debug).
"""
from __future__ import annotations

import sys


class Logger:
    def __init__(self, verbose: int = 3, stream=None):
        self.verbose = verbose
        self.stream = stream or sys.stderr

    def _emit(self, level, fmt, *args):
        if self.verbose >= level:
            msg = fmt % args if args else fmt
            print(msg, file=self.stream, flush=True)

    def info(self, fmt, *args):
        self._emit(3, fmt, *args)

    def debug(self, fmt, *args):
        self._emit(5, fmt, *args)
