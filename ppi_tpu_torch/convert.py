"""Carry models, env states, policy states and SAC networks across from
the JAX package.

All take plain numpy arrays (``np.asarray`` of each JAX field), so this
module needs no JAX. The comparison tests run the two packages from the
same numbers through these.

The JAX scripted experts start from ``env.reset(jax.random.key(0))``,
whose draws torch's generators do not give; ``KEY0_DOOR_FRAME`` (door-v0-
hand's and door-v0-adroit's sampled door frame) and ``KEY0_HAMMER_BOARD``
(hammer-v0-hand's and hammer-v0-adroit's sampled board, the raised-board
regime, dz = 0.142) are those draws, exactly, for ``reset(frame=...)`` and
``reset(board=...)``.
"""

import numpy as np
import torch

from ppi_tpu_torch.envs.ball_in_a_cup import BicState
from ppi_tpu_torch.envs.classic import ClassicState
from ppi_tpu_torch.envs.physics.engine import (
    MODEL_FIELDS, ArticulatedModel, PhysicsState)
from ppi_tpu_torch.policies.features import FeatureState
from ppi_tpu_torch.policies.gaussian import GaussianState
from ppi_tpu_torch.policies.kernels import KernelState
from ppi_tpu_torch.policies.noise import NoiseState

KEY0_DOOR_FRAME = (float.fromhex("0x1.16ebaap-1"),
                   float.fromhex("0x1.6434e4p-2"),
                   float.fromhex("0x1.f31eb8p-1"))
KEY0_HAMMER_BOARD = (float.fromhex("0x1.a3d70ap-1"), 0.0,
                     float.fromhex("0x1.7bfb18p-1"))

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
    """A KernelState on ``device`` from each field as a numpy array;
    ``hyper`` holds the kernel's 1-3 hyperparameters."""
    return KernelState(**_tensors(fields, device))


def feature_state_from_numpy(fields: dict, device) -> FeatureState:
    """A FeatureState on ``device`` from each field as a numpy array."""
    return FeatureState(**_tensors(fields, device))


def gaussian_state_from_numpy(fields: dict, device) -> GaussianState:
    """A GaussianState on ``device`` from each field as a numpy array."""
    return GaussianState(**_tensors(fields, device))


def noise_state_from_numpy(fields: dict, device) -> NoiseState:
    """A NoiseState on ``device`` from each field as a numpy array."""
    return NoiseState(**_tensors(fields, device))


def env_state_from_numpy(state_cls, fields: dict, device):
    """An env state (``DoorState``, ``PenState``, ``HammerState``,
    ``RelocateHandState``, ...) on ``device``: ``fields`` holds ``qpos``
    and ``qvel`` (the JAX state's physics), optionally ``t``, and the
    state's other fields (the goal, the frame or the board) as numpy
    arrays. The ball start of the relocate scenes is part of ``qpos``."""
    fields = dict(fields)
    physics = PhysicsState(
        qpos=torch.tensor(np.asarray(fields.pop("qpos"), np.float32),
                          device=device),
        qvel=torch.tensor(np.asarray(fields.pop("qvel"), np.float32),
                          device=device))
    t = torch.tensor(np.asarray(fields.pop("t", 0), np.int32), device=device)
    rest = {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in fields.items()}
    return state_cls(physics=physics, t=t, **rest)


def classic_state_from_numpy(fields: dict, device) -> ClassicState:
    """A pendulum's or cartpole's ``ClassicState`` on ``device`` from
    ``qpos``, ``qvel`` and optionally ``t`` as numpy arrays."""
    return ClassicState(
        qpos=torch.tensor(np.asarray(fields["qpos"], np.float32),
                          device=device),
        qvel=torch.tensor(np.asarray(fields["qvel"], np.float32),
                          device=device),
        t=torch.tensor(np.asarray(fields.get("t", 0), np.int32),
                       device=device))


def bic_state_from_numpy(fields: dict, device) -> BicState:
    """A ball-in-a-cup ``BicState`` on ``device`` from the JAX state's
    fields as numpy arrays: ``qpos`` and ``qvel`` (its ``arm``), the
    particles, the statistics, ``q0``, ``violated`` and ``t``."""
    fields = dict(fields)
    arm = PhysicsState(
        qpos=torch.tensor(np.asarray(fields.pop("qpos"), np.float32),
                          device=device),
        qvel=torch.tensor(np.asarray(fields.pop("qvel"), np.float32),
                          device=device))
    violated = torch.tensor(np.asarray(fields.pop("violated"), bool),
                            device=device)
    t = torch.tensor(np.asarray(fields.pop("t", 0), np.int32), device=device)
    rest = {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in fields.items()}
    return BicState(arm=arm, violated=violated, t=t, **rest)


def _dense_layers(tree):
    """The (kernel, bias) pairs of a flax MLP's ``Dense_0..k`` (under
    ``params`` and, for an Actor, ``MLP_0``), in order."""
    tree = tree.get("params", tree)
    tree = tree.get("MLP_0", tree)
    names = sorted((k for k in tree if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    return [(np.asarray(tree[k]["kernel"], np.float32),
             np.asarray(tree[k]["bias"], np.float32)) for k in names]


def sac_params_from_flax(params: dict) -> dict:
    """State dicts of ``runners.train_sac_expert``'s modules from the flax
    parameter trees of a JAX ``SacState`` (numpy leaves): ``params`` maps
    ``actor``, ``critic`` and ``critic_target`` to their trees; each flax
    ``Dense`` kernel (in, out) becomes a weight (out, in)."""
    out = {}
    for name, tree in params.items():
        prefix = "mlp." if name == "actor" else ""
        sd = {}
        for k, (kernel, bias) in enumerate(_dense_layers(tree)):
            sd[f"{prefix}weights.{k}"] = torch.from_numpy(kernel.T.copy())
            sd[f"{prefix}biases.{k}"] = torch.from_numpy(bias.copy())
        out[name] = sd
    return out
