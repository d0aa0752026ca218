"""Fixtures shared by the port's gradient tests (not a test module).

A test module imports the fixture by name, which registers it there."""
import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test that runs the plain versions' many
    tiny ops under autograd: with several test workers on a few cores,
    torch's thread pools contend and slow such a test a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
