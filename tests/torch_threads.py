"""One intra-op torch thread for the port's test modules.

Their tests run many small torch ops; one thread keeps them from
oversubscribing the CPU when test files run in parallel processes. The
setting is a module-scoped fixture, not a call at import, because every
test process imports every test module at collection: a call at import
would also hold the torch reference tests of other modules to one thread.
A module takes it with ``from torch_threads import one_torch_thread``."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
