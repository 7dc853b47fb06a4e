"""The benchmark's CPU tests run toy servers with poller threads beside
other test workers: one intra-op thread each keeps them from contending."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
