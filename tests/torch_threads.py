"""One torch intra-op thread for the port's CPU test files, each of which
imports `one_intra_op_thread` (an autouse module fixture). Their tests run
many small tensor ops, for which torch's intra-op thread pool costs far
more than it gives on a shared CPU: under pytest-xdist every worker would
start a pool as wide as the machine."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
