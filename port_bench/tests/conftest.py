"""The benchmark's own tests: ``python -m pytest port_bench/tests`` from the
root of the checkout.  Tests marked ``card`` need CUDA (the control and
the program's readings at the cells' sizes); here they skip, from a
fixture, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


def pytest_sessionstart(session):
    import torch

    torch.set_num_threads(2)  # several workers share the CPU
