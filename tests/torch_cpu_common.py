"""Shared by the port's CPU test files that run many small tensor
operations (tiny models stepped one token or one update at a time): one
torch thread while the module runs. Under `pytest -n 6` six workers share
the machine's cores, and torch's default of one thread a core makes every
small operation wait on busy threads; the sampled-serving test took 44x its
single-process time that way."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
