"""Fixture shared by the PyTorch port's tests.

The suite runs several pytest-xdist workers on the machine's cores, and the
JAX tests beside them are multithreaded already; the port's tests run
torch with two intra-op threads so they do not oversubscribe the cores.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
