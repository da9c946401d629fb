"""Every test process of the repo: one thread budget and a time limit per test.

pytest loads this file before ``tests/conftest.py`` (the JAX suite's
platform and tier set-up), once in each pytest-xdist worker.

Thread budget, THREADS: pytest-xdist runs several workers on the host's
cores, and a BLAS, OpenMP or torch pool of one thread per core in each of
them thrashes the cores.  Both OpenBLAS pools (numpy's, and scipy's, which
jaxlib's CPU LAPACK calls go through), OpenMP and torch are held to it for
the life of the process; the ``*_NUM_THREADS`` variables carry it to
libraries loaded later and to child processes, unless the run set them.

Time limit, TEST_TIME_LIMIT_S: each test's call fails once it has run that
long on the wall clock, so that a hung test fails alone and the rest of the
suite goes on.  Fixture set-up and teardown run outside it.
"""
import contextlib
import os
import signal
import threading

import pytest

THREADS = 2
TEST_TIME_LIMIT_S = 600

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, str(THREADS))

# the pools load with these imports
import numpy  # noqa: E402,F401
import scipy.linalg  # noqa: E402,F401
import torch  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402

threadpool_limits(THREADS)
torch.set_num_threads(THREADS)


class TimeLimitExceeded(BaseException):
    """A block ran past the wall-clock limit :func:`time_limit` gave it.

    A BaseException, as pytest's own outcomes are, so that no
    ``except Exception`` in the code under test swallows it."""


@contextlib.contextmanager
def time_limit(seconds, what):
    """Raise :class:`TimeLimitExceeded` in the block if it runs past
    ``seconds`` of wall clock.  SIGALRM, so only where the platform has
    ``setitimer`` and in the main thread; elsewhere the block runs
    unlimited.  The timer is disarmed on the way out."""
    if (not hasattr(signal, "setitimer")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expire(signum, frame):
        raise TimeLimitExceeded(f"{what} ran past its {seconds:g} s limit")

    handler = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, handler)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit(TEST_TIME_LIMIT_S, item.nodeid):
        return (yield)
