"""Shared helpers of the tests that hold the PyTorch port against the JAX
reference (tests/test_torch_*.py). Both packages run on the CPU; data passes
between them as numpy arrays."""

import numpy as np
import pytest
import torch

# the suite runs several pytest workers at once: keep each one's torch
# thread pool small
torch.set_num_threads(2)


def jnp_dict(nt) -> dict:
    """A JAX NamedTuple -> {field: numpy array}."""
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def tnp(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def cuda_device():
    """The CUDA device for tests of kernels that only run on the card;
    skips (decided at run time, never at import) where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")
