"""One intra-op torch thread for a test module's CPU work.

The suite runs in six worker processes on one host. Torch's CPU ops open a
parallel region over every core, and on a host that the other workers keep
busy each region waits for descheduled threads: a tiny render that takes
2 s alone took 97 s there. A module that imports `one_torch_thread` runs
its tests, its module fixtures included, on one thread (as
test_torch_eval_entry.py and test_torch_train_loop.py do per test).
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
