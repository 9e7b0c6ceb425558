"""Batched rollouts and the MPC objective, eager.

Port of ``ppi_tpu/envs/base.py``. ``scan`` over the horizon becomes a
Python loop and ``vmap`` over samples a leading batch dimension: the env's
``step`` runs over ``(N, ...)`` states. This eager path is the plain
version of the rollout kernel (``envs/physics/rollout_kernel.py``).

Failure containment: a diverged rollout yields NaN rewards in its own lane
only; the solver's mask turns it into a zero-weight sample.
"""

import dataclasses

import numpy as np
import torch


def as_f32(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor, array or sequence (a
    pinned goal, start or frame); arrays are copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device=device, dtype=torch.float32)


def first_accept(draws: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The first row of ``draws`` (k, ...) whose ``ok`` is set, else row 0
    (``jnp.argmax`` of the flags): a resample-until loop as a fixed number
    of draws (the reacher's target, fetch-push's goal)."""
    return draws[torch.argmax(ok.to(torch.int32))]


def _finite_lanes(state, n: int) -> torch.Tensor:
    """(n,) bool: every float tensor of ``state`` finite in that lane.

    Fields with a leading lane axis are checked per lane; fields shared by
    all lanes (the sampled frame) count for every lane."""
    ok = None
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if dataclasses.is_dataclass(x):
            lane_ok = _finite_lanes(x, n)
        elif isinstance(x, torch.Tensor) and x.is_floating_point():
            fin = torch.isfinite(x)
            lane_ok = (fin.reshape(n, -1).all(1) if x.dim() and x.shape[0] == n
                       else fin.all().expand(n))
        else:
            continue
        ok = lane_ok if ok is None else ok & lane_ok
    return ok


def rollout(env, states, actions, guard: bool = True):
    """Roll ``(N, H, d_a)`` actions from ``(N, ...)`` states; returns
    (final states, rewards (N, H)).

    With ``guard``, a non-finite state poisons that lane's reward at that
    step (NaN)."""
    n, horizon = actions.shape[0], actions.shape[1]
    rewards = []
    for t in range(horizon):
        states, r = env.step(states, actions[:, t])
        if guard:
            r = torch.where(_finite_lanes(states, n), r, torch.nan)
        rewards.append(r)
    return states, torch.stack(rewards, 1)


def broadcast_state(state, n: int):
    """Give the coordinates of a single state a leading axis of n lanes:
    those of its ``physics`` (the articulated envs), or its own ``qpos``
    and ``qvel`` (``envs.classic.ClassicState``)."""
    if not hasattr(state, "physics"):
        return dataclasses.replace(state, qpos=state.qpos.expand(n, -1),
                                   qvel=state.qvel.expand(n, -1))
    phys = state.physics
    return dataclasses.replace(state, physics=dataclasses.replace(
        phys, qpos=phys.qpos.expand(n, -1), qvel=phys.qvel.expand(n, -1)))


def batch_rollout(env, state0, action_sequences, guard: bool = True):
    """(N, H, d_a) -> (final states, (N, H) rewards), every lane starting
    from the single state ``state0``."""
    n = action_sequences.shape[0]
    return rollout(env, broadcast_state(state0, n), action_sequences, guard)


def risk_aggregate(rewards, horizon_mask=None, risk_quantile: float = 1.0,
                   risk_weight: float = 0.0):
    """(N, H) per-step rewards -> (N,) per-sample costs, optionally blended
    with the CVaR of the per-step costs (see the JAX docstring)."""
    if horizon_mask is not None:
        rewards = rewards * horizon_mask[None, :]
    costs = -rewards
    total = torch.sum(costs, dim=1)
    if risk_weight <= 0.0 or risk_quantile >= 1.0:
        return total
    h = costs.shape[1]
    k = max(1, min(h, int(round(risk_quantile * h))))
    worst = torch.topk(costs, k, dim=1).values
    cvar = torch.mean(worst, dim=1)
    return (1.0 - risk_weight) * total + risk_weight * h * cvar


def mpc_objective(env, state0, horizon_mask=None, guard: bool = True,
                  risk_quantile: float = 1.0, risk_weight: float = 0.0):
    """Build the ``f(generator, actions) -> costs`` callable the solvers
    consume; ``horizon_mask`` (H,) zeroes rewards past the episode end."""

    def f(generator, action_sequences):
        del generator
        _, rewards = batch_rollout(env, state0, action_sequences, guard)
        return risk_aggregate(rewards, horizon_mask, risk_quantile,
                              risk_weight)

    return f
