"""One intra-op thread for the port's small CPU tests.

The suite runs several pytest workers on the host's cores; torch's default
of one thread per core in every worker oversubscribes them, and its small
ops (tiny convs, float64 gradcheck) then wait on each other's threads far
longer than they compute. Tests import ``one_thread`` to run with one.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
