"""One intra-op torch thread for a port test module.

The tier-1 run puts several pytest workers on the same cores, and torch's
default of one intra-op thread per core in every worker oversubscribes them
many times over. A port CPU test module imports the fixture, which then
applies to every test in it:

    from torch_threads import one_torch_thread  # noqa: F401 (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
