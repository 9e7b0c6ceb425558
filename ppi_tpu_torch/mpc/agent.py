"""Receding-horizon MPC agent.

Port of ``Mpc`` from ``ppi_tpu/mpc/agent.py``. One control step shifts the
GP prior onto the current window, runs ``n_iters`` x (sample -> N rollouts
-> posterior update) and returns the first action of the posterior mean.
The window is always H steps; a reward mask zeroes steps past the episode.

On a CUDA device every rollout of an env with the scalar kernel contract
is one launch of the hand-written kernel (``kernel_mpc_objective``), as
the reference routes by ``use_pallas``; on the CPU, and for an env without
the contract (which has no kernel in either package), the eager objective
runs (``mpc_objective``). Both reduce the (N, H) rewards with
``risk_aggregate``. The loop reads nothing back from the device: the no-op
window shift is decided from the integer time index in the carry.

With a ``mesh`` (``ppi_tpu_torch.parallel``, the reference's ``mesh``),
each rank runs this agent as a replica and only the rollout is split over
the mesh axis: ``sharded_kernel_mpc_objective`` on a CUDA device for an env
with the kernel contract, the eager ``sharded_mpc_objective`` otherwise.
The port has no ``use_pallas``: it routes by device.
"""

import dataclasses
from typing import Any

import torch

from ppi_tpu_torch.algorithms.base import _one_iteration
from ppi_tpu_torch.envs.base import mpc_objective
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    kernel_mpc_objective, sharded_kernel_mpc_objective, supports_kernel)
from ppi_tpu_torch.parallel.mesh import sharded_mpc_objective


@dataclasses.dataclass(frozen=True)
class MpcCarry:
    """Everything the agent threads between control steps."""

    policy: Any                  # policy state
    generator: torch.Generator   # every draw of the agent
    window: int                  # time index of the policy's current window


@dataclasses.dataclass(frozen=True)
class Mpc:
    """MPC agent configuration (static)."""

    env: Any
    solver: Any
    family: Any
    timesteps: int            # episode length T
    horizon: int              # planning horizon H
    n_samples: int
    n_iters: int = 1
    anneal: float = 1.0
    use_map: bool = False     # return the MAP first action
    device: Any = "cuda"      # the card, unless the caller names the CPU
    risk_quantile: float = 1.0  # CVaR quantile over per-step costs
    risk_weight: float = 0.0    # blend weight of the CVaR term; 0 = plain
                                # -sum(rewards) (envs.base.risk_aggregate)
    mesh: Any = None          # parallel.Mesh -> shard the sample axis
    mesh_axis: Any = "samples"  # mesh axis name, or a tuple for hierarchical
                              # multi-slice sharding (("slices", "samples"))

    def __post_init__(self):
        if self.mesh is not None:
            self.mesh.check_device(self.device)

    @property
    def dt(self) -> float:
        return self.env.dt

    def init(self, policy_state, generator: torch.Generator) -> MpcCarry:
        """Precompute the prior on the initial window."""
        policy_state = self.family.compute_prior(policy_state,
                                                 self.time_window(0))
        return MpcCarry(policy=policy_state, generator=generator, window=0)

    def time_window(self, time_index: int):
        """H-step window starting at time_index (always full length)."""
        return self.dt * (torch.arange(self.horizon, device=self.device)
                          + time_index)

    def horizon_mask(self, time_index: int):
        return ((torch.arange(self.horizon, device=self.device) + time_index)
                < self.timesteps).to(torch.float32)

    def objective(self, env_state, time_index: int):
        mask = self.horizon_mask(time_index)
        risk = dict(risk_quantile=self.risk_quantile,
                    risk_weight=self.risk_weight)
        kernel = torch.device(self.device).type == "cuda" \
            and supports_kernel(self.env)
        if self.mesh is not None:
            if kernel:
                return sharded_kernel_mpc_objective(
                    self.env, env_state, self.horizon, self.mesh, mask,
                    axis=self.mesh_axis, **risk)
            return sharded_mpc_objective(self.env, env_state, self.mesh,
                                         mask, axis=self.mesh_axis, **risk)
        if kernel:
            return kernel_mpc_objective(self.env, env_state, self.horizon,
                                        mask, **risk)
        return mpc_objective(self.env, env_state, mask, **risk)

    def optimize(self, carry: MpcCarry, env_state, time_index: int,
                 n_iters: int):
        """Run n_iters solver iterations about (env_state, time_index);
        returns (carry, stats stacked over iterations, last costs)."""
        policy = self.family.update_timesteps(
            carry.policy, self.time_window(time_index), self.anneal,
            same=time_index == carry.window)
        policy = self.solver.reset(self.family, policy)
        step = _one_iteration(self.solver, self.family,
                              self.objective(env_state, time_index),
                              self.n_samples)
        trace, costs = [], None
        for _ in range(n_iters):
            policy, (stats, _, costs) = step(policy, carry.generator)
            trace.append(stats)
        stacked = {k: torch.stack([s[k] for s in trace]) for k in trace[0]}
        return (dataclasses.replace(carry, policy=policy, window=time_index),
                stacked, costs)

    def action(self, carry: MpcCarry):
        if self.use_map:
            return self.family.map_action_sequence(carry.policy)[0, :]
        return self.family.predict_mean(carry.policy)[0, :]

    def control_step(self, carry: MpcCarry, env_state, time_index: int):
        """One MPC control step; returns (action, carry, stats)."""
        carry, trace, last_costs = self.optimize(carry, env_state,
                                                 time_index, self.n_iters)
        stats = {k: v[-1] for k, v in trace.items()}
        stats["costs"] = last_costs
        return self.action(carry), carry, stats

    def warm_start(self, carry: MpcCarry, env_state, n_iters: int = 50):
        """Long optimization at t=0 before the episode."""
        carry, trace, _ = self.optimize(carry, env_state, 0, n_iters)
        return carry, trace

    def _step(self, carry: MpcCarry, env_state, t: int, collect: bool):
        """One closed-loop step at time index ``t``: plan, act, observe.
        Returns (carry, env_state, row); the row holds the action, reward,
        ess, alpha, observation, ``qpos`` for an env with physics and, with
        ``collect``, the (N,) costs of the last iteration."""
        action, carry, stats = self.control_step(carry, env_state, t)
        env_state, reward = self.env.step(env_state, action)
        row = dict(action=action, reward=reward, ess=stats["ess"],
                   alpha=stats["alpha"], obs=self.env.observe(env_state))
        if hasattr(env_state, "physics"):
            row["qpos"] = env_state.physics.qpos
        if collect:
            row["costs"] = stats["costs"]
        return carry, env_state, row

    def run_episode(self, carry: MpcCarry, env_state, callback=None,
                    collect: bool = False):
        """The closed-loop episode; returns (carry, env_state, track) with
        the rows of ``_step`` stacked over time (``costs`` (T, N) with
        ``collect``). ``callback(t, env_state, row)`` sees every step and
        ends the episode by returning True."""
        track = []
        for t in range(self.timesteps):
            carry, env_state, row = self._step(carry, env_state, t, collect)
            track.append(row)
            if callback is not None and callback(t, env_state, row):
                break
        return carry, env_state, _stack(track)

    def _episode_chunk(self, carry: MpcCarry, env_state, t0: int,
                       length: int, callback=None):
        """``length`` steps from time index ``t0``, each the step of
        ``run_episode``: returns ((carry, env_state), track)."""
        track = []
        for t in range(t0, t0 + length):
            carry, env_state, row = self._step(carry, env_state, t, False)
            track.append(row)
            if callback is not None:
                callback(t, env_state, row)
        return (carry, env_state), _stack(track)

    def run_episode_resumable(self, carry: MpcCarry, env_state,
                              start: int = 0, chunk: int = 50,
                              on_chunk=None, callback=None):
        """The episode from step ``start`` in chunks of ``chunk`` steps;
        ``on_chunk(t, carry, env_state, tracks)`` fires after each chunk
        with the chunk tracks so far (the checkpoint hook of ``run_mpc
        --checkpoint-every``). A chunk is the same per-step program as
        ``run_episode``, so an episode resumed from a saved (carry,
        env_state, t) is bit for bit the uninterrupted one."""
        tracks, t = [], start
        while t < self.timesteps:
            n = min(chunk, self.timesteps - t)
            (carry, env_state), tr = self._episode_chunk(
                carry, env_state, t, n, callback)
            tracks.append(tr)
            t += n
            if on_chunk is not None:
                on_chunk(t, carry, env_state, tracks)
        track = ({k: torch.cat([tr[k] for tr in tracks]) for k in tracks[0]}
                 if tracks else {})
        return carry, env_state, track


def _stack(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
