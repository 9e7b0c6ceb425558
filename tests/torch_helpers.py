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


# door-v0's door coordinate and the stop of ``door_clamp``
DOOR_Q, CLAMP_AT = 4, 0.02


def door_clamp(m, q_prev, q, qd):
    """A synthetic per-step projection on door-v0, written over
    ``scalar_math``: a door that started the step at most 1e-3 past
    CLAMP_AT stops there, its opening velocity zeroed (the hand scenes'
    bolt, on the 6-DoF model)."""
    from ppi_tpu_torch.envs.physics import scalar_math as sm
    del m
    q, qd = list(q), list(qd)
    hit = sm.logical_and(sm.gt(q[DOOR_Q], CLAMP_AT),
                         sm.lt(q_prev[DOOR_Q], CLAMP_AT + 1e-3))
    qd[DOOR_Q] = sm.where(hit, sm.minimum(qd[DOOR_Q], 0.0), qd[DOOR_Q])
    q[DOOR_Q] = sm.where(hit, CLAMP_AT, q[DOOR_Q])
    return tuple(q), tuple(qd)
