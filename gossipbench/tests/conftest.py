"""The benchmark's own tests: small sizes on the CPU (the card's tests
carry the ``cuda`` marker and skip without one)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    # several workers each spinning OpenMP threads thrash the host
    torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
