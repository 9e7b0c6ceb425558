"""Episodic policy-search environments.

Port of ``ppi_tpu/envs/episodic.py``: an environment evaluates a batch of
action (joint-trajectory) sequences to episodic costs.

  * ``TestEnv`` -- the physics-free sinusoid-tracking mock: the cost is the
    mean squared error of the "joint" channels to a bank of sinusoids. It
    exercises the actions-to-joints mapping, the matrix-normal prior and
    the solver loop with no simulation.
  * ``BallInACup`` -- the ball-in-a-cup task: on a CUDA device one
    evaluation is one launch of the ball-in-a-cup kernel
    (``envs/physics/bic_kernel.py``), a warp a trajectory; on the CPU its
    plain version, the eager scalar program (slow: tests use short
    phases). Costs are the negated rewards shifted by -100, as the
    reference's.

Every ``objective()`` is ``f(generator, actions) -> (costs, {"success_rate":
successes})``; neither env draws from the generator.
"""

import dataclasses

import numpy as np
import torch

from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
from ppi_tpu_torch.envs.physics import bic_kernel


@dataclasses.dataclass(frozen=True)
class TestEnv:
    """Sinusoid tracking: cost = MSE of the 'joint' trajectories to a bank
    of sinusoids."""

    __test__ = False  # not a pytest class

    dim_action: int = 2
    dim_dof: int = 2
    n_steps: int = 100
    condition: bool = False

    name = "Test"

    @property
    def t(self):
        return torch.linspace(0.0, 1.0, self.n_steps)

    @property
    def action_0(self):
        return torch.zeros(self.dim_action)

    def target(self, device):
        """(n_steps, dim_action): channel k tracks 0.5 a_k sin(4 (k+1) t),
        the a_k evenly spaced over [-1, 1]."""
        amps = np.linspace(-1.0, 1.0, self.dim_action)
        t = np.linspace(0.0, 1.0, self.n_steps)
        bank = np.stack([0.5 * amps[k] * np.sin(4 * (k + 1) * t)
                         for k in range(self.dim_action)], axis=1)
        return torch.from_numpy(bank.astype(np.float32)).to(device)

    def map_actions_to_joints(self, action_sequences):
        d = self.dim_dof
        return action_sequences[..., :d], action_sequences[..., d:]

    def evaluate(self, generator, action_sequences):
        """(N, T, 2 d) -> (costs (N,), successes (N,) bool)."""
        del generator
        qs, _ = self.map_actions_to_joints(action_sequences)
        err = qs - self.target(qs.device)[None]
        costs = torch.mean(err ** 2, dim=(1, 2))
        return costs, torch.zeros_like(costs, dtype=torch.bool)

    def objective(self):
        def f(generator, actions):
            costs, successes = self.evaluate(generator, actions)
            return costs, {"success_rate": successes}
        return f


@dataclasses.dataclass(frozen=True)
class BallInACup:
    """Episodic ball-in-a-cup. The policy's two position and two velocity
    channels drive joints 1 and 3 (shoulder pitch and elbow); the other
    joints hold their start pose. ``sim`` defaults to the canonical
    ``BallInCupSim``; a runner passes another for another string
    resolution."""

    dim_action: int = 2
    dim_dof: int = 4
    time_horizon: float = 2.0
    condition: bool = True
    rigid: bool = False
    sim: BallInCupSim = None

    name = "BallInACup"
    action_indices = (1, 3)

    def __post_init__(self):
        if self.rigid:
            raise NotImplementedError(
                "BallInACup(rigid=True): the rigid articulated string "
                "(ppi_tpu/envs/ball_in_a_cup_rigid.py) is not ported; it is "
                "the last item of ROADMAP.md queue 1 (BallInACupRigid)")
        if self.sim is None:
            object.__setattr__(self, "sim", BallInCupSim())

    @property
    def dt(self) -> float:
        return self.sim.effective_dt

    @property
    def t(self):
        n = int(self.time_horizon / self.dt)
        return torch.linspace(0.0, self.time_horizon, n)

    @property
    def action_0(self):
        return torch.tensor([0.0, 1.5707])

    @property
    def q_start(self):
        return torch.tensor([0.0, 0.0, 0.0, 1.5707])

    def map_actions_to_joints(self, action_sequences):
        """(N, T, 4) -> desired (q, qd) each (N, T, 4) with only the two
        actuated joints driven."""
        d = action_sequences.shape[-1]
        if d != 2 * self.dim_action:
            raise ValueError(f"actions of width {d}, expected "
                             f"{2 * self.dim_action}")
        return bic_kernel.joint_setpoints(action_sequences)

    def rollout(self):
        """The wrapper of the ball-in-a-cup kernel for ``sim``
        (``bic_kernel.make_bic_rollout``), one per env."""
        run = self.__dict__.get("_run")
        if run is None:
            run = bic_kernel.make_bic_rollout(self.sim)
            object.__setattr__(self, "_run", run)
        return run

    def evaluate(self, generator, action_sequences):
        """(N, T, 4) -> (costs (N,), successes (N,) bool): one launch of the
        ball-in-a-cup kernel on a CUDA device, stabilize + trajectory +
        cool-down for every sample; the plain version on the CPU."""
        del generator
        if action_sequences.shape[-1] != 2 * self.dim_action:
            raise ValueError(f"actions of width {action_sequences.shape[-1]},"
                             f" expected {2 * self.dim_action}")
        q = self.q_start.to(action_sequences.device)
        _, reward, success = self.rollout()(q, action_sequences)
        return -(reward - 100.0), success != 0

    def objective(self):
        def f(generator, actions):
            costs, successes = self.evaluate(generator, actions)
            return costs, {"success_rate": successes}
        return f


EPISODIC_ENVS = {"Test": TestEnv, "BallInACup": BallInACup}
