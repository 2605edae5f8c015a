"""Settings for the port's CPU tests."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def one_torch_thread():
    """The plain engine runs many small ops; under several test workers,
    PyTorch's default thread pool per worker oversubscribes the cores and
    makes each op tens of times slower."""
    torch.set_num_threads(1)
