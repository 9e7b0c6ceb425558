"""Analytic low-dimensional control environments: pendulum and cartpole.

Port of ``ppi_tpu/envs/classic.py``: closed-form dynamics with known
behaviour (energy conservation, equilibria), the smallest end-to-end MPC
slice. They have no scalar kernel contract, so the MPC agent plans them
through the eager objective on every device (``envs.base.mpc_objective``);
the JAX package has no Pallas kernel for them either.

``step`` takes a state and an action with any leading batch shape (the
lanes of a rollout first), as the port's other eager envs do. The angle
wrap is ``torch.remainder``, JAX's ``jnp.mod`` (floored: the result takes
the divisor's sign), not ``torch.fmod``, which differs for negative angles.
"""

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ClassicState:
    qpos: torch.Tensor  # (..., nq)
    qvel: torch.Tensor  # (..., nq)
    t: torch.Tensor     # () int32 step counter


def _wrap(th):
    """The angle in [-pi, pi): ``jnp.mod(th + pi, 2 pi) - pi``."""
    return torch.remainder(th + math.pi, 2.0 * math.pi) - math.pi


@dataclasses.dataclass(frozen=True)
class Pendulum:
    """Torque-limited pendulum swing-up. theta = 0 is upright."""

    action_dim: int = 1
    dt: float = 0.05
    gravity: float = 9.81
    mass: float = 1.0
    length: float = 1.0
    max_torque: float = 2.0
    max_speed: float = 8.0

    name = "pendulum"

    @property
    def action_low(self):
        return -self.max_torque * torch.ones(1)

    @property
    def action_high(self):
        return self.max_torque * torch.ones(1)

    def reset(self, generator, device):
        """Hanging down at rest; the start is deterministic."""
        del generator
        return ClassicState(
            qpos=torch.full((1,), math.pi, device=device),
            qvel=torch.zeros(1, device=device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    def step(self, state: ClassicState, action):
        """(state, action (..., 1)) -> (next state, reward (...))."""
        th, thdot = state.qpos[..., 0], state.qvel[..., 0]
        u = torch.clamp(action[..., 0], -self.max_torque, self.max_torque)
        ml2 = self.mass * self.length ** 2
        # semi-implicit Euler, upright at 0
        acc = (3.0 * self.gravity / (2.0 * self.length) * torch.sin(th)
               + 3.0 / ml2 * u)
        thdot = torch.clamp(thdot + acc * self.dt, -self.max_speed,
                            self.max_speed)
        th = th + thdot * self.dt
        next_state = ClassicState(qpos=th[..., None], qvel=thdot[..., None],
                                  t=state.t + 1)
        reward = -(_wrap(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2)
        return next_state, reward

    def observe(self, state: ClassicState):
        th = state.qpos[..., 0]
        return torch.stack([torch.cos(th), torch.sin(th),
                            state.qvel[..., 0]], -1)


@dataclasses.dataclass(frozen=True)
class Cartpole:
    """Cart-pole swing-up with force control on the cart."""

    action_dim: int = 1
    dt: float = 0.02
    gravity: float = 9.81
    mass_cart: float = 1.0
    mass_pole: float = 0.1
    length: float = 0.5  # half pole length
    max_force: float = 10.0
    x_limit: float = 2.4

    name = "cartpole"

    @property
    def action_low(self):
        return -self.max_force * torch.ones(1)

    @property
    def action_high(self):
        return self.max_force * torch.ones(1)

    def reset(self, generator, device):
        """The pole hanging down at rest; the start is deterministic."""
        del generator
        return ClassicState(
            qpos=torch.tensor([0.0, math.pi], device=device),
            qvel=torch.zeros(2, device=device),
            t=torch.zeros((), dtype=torch.int32, device=device))

    def step(self, state: ClassicState, action):
        """(state, action (..., 1)) -> (next state, reward (...))."""
        x, th = state.qpos[..., 0], state.qpos[..., 1]
        xd, thd = state.qvel[..., 0], state.qvel[..., 1]
        f = torch.clamp(action[..., 0], -self.max_force, self.max_force)
        mp, mc, l = self.mass_pole, self.mass_cart, self.length
        total = mp + mc
        sin, cos = torch.sin(th), torch.cos(th)
        # the standard cartpole equations, theta = 0 upright
        tmp = (f + mp * l * thd ** 2 * sin) / total
        th_acc = (self.gravity * sin - cos * tmp) / (
            l * (4.0 / 3.0 - mp * cos ** 2 / total))
        x_acc = tmp - mp * l * th_acc * cos / total
        xd = xd + x_acc * self.dt
        thd = thd + th_acc * self.dt
        x = x + xd * self.dt
        th = th + thd * self.dt
        next_state = ClassicState(qpos=torch.stack([x, th], -1),
                                  qvel=torch.stack([xd, thd], -1),
                                  t=state.t + 1)
        upright = torch.cos(_wrap(th))
        reward = (upright - 0.1 * x ** 2 - 0.01 * xd ** 2 - 0.01 * thd ** 2
                  - 0.001 * f ** 2)
        # the out-of-track penalty
        reward = reward - 10.0 * (torch.abs(x) > self.x_limit).to(x.dtype)
        return next_state, reward

    def observe(self, state: ClassicState):
        x, th = state.qpos[..., 0], state.qpos[..., 1]
        return torch.stack([x, torch.cos(th), torch.sin(th),
                            state.qvel[..., 0], state.qvel[..., 1]], -1)
