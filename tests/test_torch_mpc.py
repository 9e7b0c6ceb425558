"""The slice as a whole: the port's MPC agent against the JAX agent.

Door(fixed_scene=True), N=16, H=8, T=3, n_iters=2, anneal 0.5 and 2
warm-start iterations. Both packages' base draws are patched to one fixed
numpy array, returned on every call: JAX traces the draw once inside
lax.scan, so it sees one array on every iteration, and the port must too.
The JAX agent rolls out on its scan path (use_pallas=False), which
tests/test_pallas_rollout.py certifies equal to the kernel.

Tolerances. The first control step (after the warm start) agrees to 1e-4.
Later steps drift a little further, measured 1.7e-4 at T=3, for a reason
outside the port: the two packages' rollout costs differ by a few ulps
(XLA's and torch's sin/cos/sqrt), min-max normalization divides that by a
cost range about 1% of the cost magnitude, and LBPS's bound is flat at its
minimum, so the chosen temperature moves (measured 2.5e-5 relative at step
0, one final grid cell at step 2) and the next window's posterior carries
it. The episode's actions are held to 5e-4 and its states to 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
import ppi_tpu.policies.primitives as jax_primitives
import ppi_tpu_torch.policies.primitives as primitives
from ppi_tpu.algorithms import make_solver as jax_make_solver
from ppi_tpu.envs.door import Door as JaxDoor
from ppi_tpu.mpc import Mpc as JaxMpc
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.envs.door import Door
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.policies import design_moments, make_policy
from ppi_tpu_torch.runners import run_mpc

N, H, T, ITERS, WARM = 16, 8, 3, 2, 2


@pytest.fixture(scope="module")
def z():
    return np.random.default_rng(0).standard_normal((N, H * 4)).astype(
        np.float32)


def _jax_episode(z):
    env = JaxDoor(fixed_scene=True)
    mean, cov_in, cov_out = jax_design_moments(env.action_low,
                                               env.action_high, 1000.0)
    family, policy = jax_make_policy(
        "SquaredExponentialKernel", env.dt * jnp.arange(H), env.action_dim,
        mean, cov_in, cov_out, lengthscale=0.08, lower=env.action_low,
        upper=env.action_high)
    agent = JaxMpc(env=env, solver=jax_make_solver("Lbps", delta=0.9),
                   family=family, timesteps=T, horizon=H, n_samples=N,
                   n_iters=ITERS, anneal=0.5, use_pallas=False)
    carry = agent.init(policy, jax.random.key(0))
    state = env.reset(jax.random.key(0))
    carry, _ = agent.warm_start(carry, state, WARM)
    _, final, track = agent.run_episode(carry, state)
    return track, final


def _port_episode():
    env = Door(fixed_scene=True)
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           1000.0)
    family, policy = make_policy(
        "SquaredExponentialKernel", env.dt * torch.arange(H), env.action_dim,
        mean, cov_in, cov_out, lengthscale=0.08, lower=env.action_low,
        upper=env.action_high, device="cpu")
    agent = Mpc(env=env, solver=make_solver("Lbps", delta=0.9),
                family=family, timesteps=T, horizon=H, n_samples=N,
                n_iters=ITERS, anneal=0.5, device="cpu")
    carry = agent.init(policy, torch.Generator().manual_seed(0))
    state = env.reset(None, "cpu")
    carry, trace = agent.warm_start(carry, state, WARM)
    assert trace["alpha"].shape == (WARM,)
    _, final, track = agent.run_episode(carry, state)
    return track, final


@pytest.fixture(scope="module")
def episodes(z):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_primitives, "draw_base",
                   lambda kind, key, n, dim: jnp.asarray(z))
        mp.setattr(primitives, "draw_base",
                   lambda kind, gen, n, dim, device: to_torch(z))
        return _jax_episode(z), _port_episode()


def test_first_action_matches_reference(episodes):
    (jtrack, _), (track, _) = episodes
    np.testing.assert_allclose(to_np(track["action"][0]),
                               np.asarray(jtrack["action"][0]), atol=1e-4)


def test_per_step_actions_match_reference(episodes):
    (jtrack, _), (track, _) = episodes
    assert track["action"].shape == (T, 4)
    np.testing.assert_allclose(to_np(track["action"]),
                               np.asarray(jtrack["action"]), atol=5e-4)


def test_episode_rewards_and_state_match_reference(episodes):
    (jtrack, jfinal), (track, final) = episodes
    np.testing.assert_allclose(to_np(track["reward"]),
                               np.asarray(jtrack["reward"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(final.physics.qpos),
                               np.asarray(jfinal.physics.qpos), atol=1e-3)
    np.testing.assert_allclose(to_np(track["obs"]), np.asarray(jtrack["obs"]),
                               atol=1e-3)
    assert int(final.t) == T


def test_runner_main_runs_on_cpu():
    """The port's runner end to end at a tiny size, on the plain rollout."""
    args = run_mpc.build_parser().parse_args([
        "Lbps", "door-v0", "SquaredExponentialKernel", "--delta", "0.9",
        "--n-iters", "2", "--anneal", "0.5", "--lengthscale", "0.08",
        "--horizon", "6", "--timesteps", "3", "--n-warmstart-iters", "2",
        "--device", "cpu", "MonteCarlo", "--n-samples", "12"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success in (True, False)
    assert track["action"].shape == (3, 4)
    assert bool(torch.isfinite(track["obs"]).all())
