"""A fixture for the port's cluster tests on the CPU: each test runs with
one intra-op torch thread.  A simulation makes many small torch calls, and
idle OpenMP threads spin between them, which starves the other test
workers of the machine for little gain here.  A test module takes it with
`from tests.torch_threads import one_torch_thread  # noqa: F401`."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
