"""The port's test modules run one torch thread each: Tier-1 runs six test
workers on a few cores, and more threads would oversubscribe them.  A
module takes the fixture by importing it."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
