"""The benchmark's tests run whole tiny SLAM runs on the CPU; with several
test workers on one machine, torch's default of one thread per core
oversubscribes it many times over, so each worker keeps to two."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    torch.set_num_threads(2)
    yield
