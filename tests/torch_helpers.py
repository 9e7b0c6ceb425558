"""Shared helpers of the torch-port comparison tests (tests/test_torch_*.py).

Each test feeds the same numpy inputs to a ``ppi_tpu`` function and its
``ppi_tpu_torch`` port and compares the outputs as numpy arrays.
"""

import numpy as np
import torch

# one intra-op thread: the suite runs in several xdist workers beside the
# JAX tests, which must not be oversubscribed
torch.set_num_threads(1)


def to_torch(x, dtype=torch.float32):
    """numpy / JAX / list -> a CPU torch tensor (a copy)."""
    return torch.tensor(np.array(x), dtype=dtype)


def to_np(x):
    """torch / JAX -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def door_q0(n: int) -> np.ndarray:
    """The door-v0 initial configuration in n lanes."""
    return np.tile(np.array([0.0, 0.6, -0.8, 0.2, 0.0, 0.0], np.float32),
                   (n, 1))
