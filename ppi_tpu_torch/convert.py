"""Carry models and policy states across from the JAX package.

Both take plain numpy arrays (``np.asarray`` of each JAX field), so this
module needs no JAX. The comparison tests run the two packages from the
same numbers through these.
"""

import numpy as np
import torch

from ppi_tpu_torch.envs.physics.engine import MODEL_FIELDS, ArticulatedModel
from ppi_tpu_torch.policies.gaussian import GaussianState
from ppi_tpu_torch.policies.kernels import KernelState

_INT_FIELDS = {"sphere_body", "pair_sphere_plane", "pair_sphere_sphere",
               "pair_sphere_segment"}


def model_from_numpy(fields: dict, parents, joint_types) -> ArticulatedModel:
    """An ArticulatedModel from each field as a numpy array."""
    missing = set(MODEL_FIELDS) - set(fields)
    if missing:
        raise KeyError(f"missing model fields: {sorted(missing)}")
    return ArticulatedModel(
        **{k: np.asarray(fields[k],
                         np.int32 if k in _INT_FIELDS else np.float32)
           for k in MODEL_FIELDS},
        parents=tuple(int(p) for p in parents),
        joint_types=tuple(int(j) for j in joint_types))


def _tensors(fields: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in fields.items()}


def kernel_state_from_numpy(fields: dict, device) -> KernelState:
    """A KernelState on ``device`` from each field as a numpy array."""
    return KernelState(**_tensors(fields, device))


def gaussian_state_from_numpy(fields: dict, device) -> GaussianState:
    """A GaussianState on ``device`` from each field as a numpy array."""
    return GaussianState(**_tensors(fields, device))
