"""The test processes' thread budget and per-test time limit (the repo
root's conftest.py)."""
import os
import signal
import time

import pytest
import torch
from threadpoolctl import threadpool_info


@pytest.fixture
def budget(pytestconfig):
    """The root conftest module, as pytest registered it."""
    path = pytestconfig.rootpath / "conftest.py"
    return pytestconfig.pluginmanager.get_plugin(str(path))


def test_every_pool_keeps_the_budget(budget):
    pools = threadpool_info()
    assert {p["user_api"] for p in pools} >= {"blas", "openmp"}, pools
    assert all(p["num_threads"] <= budget.THREADS for p in pools), pools
    assert torch.get_num_threads() == budget.THREADS
    # a value the run set itself stays; otherwise the budget's
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        assert int(os.environ[var]) >= 1, var


def test_each_test_runs_under_its_limit(budget):
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= budget.TEST_TIME_LIMIT_S


@pytest.mark.parametrize("limit,sleep,raises", [(1.0, 3.0, True),
                                                 (2.0, 0.1, False)])
def test_time_limit(budget, limit, sleep, raises):
    handler = signal.getsignal(signal.SIGALRM)
    start = time.monotonic()
    if raises:
        with pytest.raises(budget.TimeLimitExceeded,
                           match="sleeper.*1 s limit"):
            with budget.time_limit(limit, "sleeper"):
                time.sleep(sleep)
        assert time.monotonic() - start < sleep
    else:
        with budget.time_limit(limit, "sleeper"):
            time.sleep(sleep)
    # disarmed, and the handler before it back
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0
    assert signal.getsignal(signal.SIGALRM) is handler
