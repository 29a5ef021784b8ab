"""One autouse fixture for the port's tool tests: each test, and any
process it starts, on one intra-op thread.  The suite runs files in
parallel processes, and a thread pool per process on every core slows
each of them a hundredfold; these tests' tensors are small.

    from _torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)
