"""A fixture for the port's test files that run thousands of small torch
operations (TINY models through whole recipes): torch's intra-op pool is
capped at two threads while the module runs. Under a parallel test run
(pytest-xdist, a process per core) each small operation would otherwise
wake a thread per core in every process, and the processes' threads
contend: one recovery case of the MIR-ST500 recipe took 54 s against 3 s
with five other cores busy, and 4 s at two threads. Results do not depend
on it: every comparison holds at any thread count.

Import the fixture into a test module to apply it there::

    from tests.torch_threads import two_torch_threads  # noqa: F401
"""
import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, before))
    yield
    torch.set_num_threads(before)
