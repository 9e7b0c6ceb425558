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

import dataclasses

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


# ---- risk-averse costs and the objective's route ----------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weight", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("quantile", [0.1, 0.25, 1.0])
def test_risk_aggregate_matches_reference(quantile, weight, masked):
    """The CVaR blend on the same (N, H) rewards; values only (top-k may
    order ties differently), to 1e-6 relative to the size of the blended
    terms (H x the largest per-step cost of the sample): the blend of two
    terms of size ~10 may cancel to ~0.1."""
    from ppi_tpu.envs.base import risk_aggregate as jax_risk_aggregate
    from ppi_tpu_torch.envs.base import risk_aggregate
    rng = np.random.default_rng(5)
    rewards = rng.standard_normal((32, 12)).astype(np.float32)
    mask = (np.arange(12) < 9).astype(np.float32) if masked else None
    got = risk_aggregate(to_torch(rewards),
                         None if mask is None else to_torch(mask), quantile,
                         weight)
    ref = jax_risk_aggregate(jnp.asarray(rewards),
                             None if mask is None else jnp.asarray(mask),
                             quantile, weight)
    costs = rewards * (1.0 if mask is None else mask)
    scale = costs.shape[1] * np.abs(costs).max(1)
    assert np.all(np.abs(to_np(got) - np.asarray(ref)) <= 1e-6 * scale)


@pytest.fixture(scope="module")
def reacher_case():
    from ppi_tpu_torch.envs.reacher import Reacher
    env = Reacher()
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    acts = to_torch(1.5 * np.random.default_rng(1).standard_normal(
        (10, 6, 2)))
    mask = to_torch((np.arange(6) < 4).astype(np.float32))
    return env, state, acts, mask


def test_kernel_objective_at_zero_risk_is_the_plain_sum(reacher_case):
    """risk_weight 0 gives -sum(masked rewards) bit for bit, the costs the
    objective gave before it took the risk knobs."""
    from ppi_tpu_torch.envs.physics.rollout_kernel import (
        env_plain_rollout, kernel_mpc_objective)
    env, state, acts, mask = reacher_case
    n = acts.shape[0]
    rew = env_plain_rollout(env, state, state.physics.qpos.expand(n, -1),
                            state.physics.qvel.expand(n, -1), acts)[0]
    for quantile in (0.25, 1.0):
        costs = kernel_mpc_objective(env, state, 6, mask,
                                     risk_quantile=quantile)(None, acts)
        assert torch.equal(costs, -torch.sum(rew * mask[None, :], dim=1))


@pytest.mark.parametrize("weight", [0.5, 1.0])
def test_kernel_objective_applies_the_risk_blend(reacher_case, weight):
    from ppi_tpu_torch.envs.base import mpc_objective, risk_aggregate
    from ppi_tpu_torch.envs.physics.rollout_kernel import (
        env_plain_rollout, kernel_mpc_objective)
    env, state, acts, mask = reacher_case
    n = acts.shape[0]
    rew = env_plain_rollout(env, state, state.physics.qpos.expand(n, -1),
                            state.physics.qvel.expand(n, -1), acts)[0]
    costs = kernel_mpc_objective(env, state, 6, mask, risk_quantile=0.25,
                                 risk_weight=weight)(None, acts)
    assert torch.equal(costs, risk_aggregate(rew, mask, 0.25, weight))
    assert not torch.allclose(costs, -torch.sum(rew * mask[None, :], 1))
    eager = mpc_objective(env, state, mask, risk_quantile=0.25,
                          risk_weight=weight)(None, acts)
    np.testing.assert_allclose(to_np(costs), to_np(eager), rtol=1e-5)


def _agent(env, device, **kwargs):
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           1000.0)
    family, _ = make_policy(
        "SquaredExponentialKernel", env.dt * torch.arange(6), env.action_dim,
        mean, cov_in, cov_out, lengthscale=0.08, device="cpu")
    return Mpc(env=env, solver=make_solver("Lbps", delta=0.9),
               family=family, timesteps=10, horizon=6, n_samples=10,
               device=device, **kwargs)


def test_mpc_passes_its_risk_fields_to_the_objective(reacher_case):
    from ppi_tpu_torch.envs.base import mpc_objective
    env, state, acts, _ = reacher_case
    agent = _agent(env, "cpu", risk_quantile=0.25, risk_weight=0.5)
    got = agent.objective(state, 7)(None, acts)
    mask = agent.horizon_mask(7)
    assert float(mask.sum()) == 3.0
    ref = mpc_objective(env, state, mask, risk_quantile=0.25,
                        risk_weight=0.5)(None, acts)
    assert torch.equal(got, ref)
    assert not torch.equal(got, _agent(env, "cpu").objective(state, 7)(
        None, acts))


class _NoContract:
    """An env without the scalar kernel contract (no scalar_torque)."""

    action_dim, dt = 1, 0.05


@pytest.mark.parametrize("contract", [False, True])
def test_objective_routes_by_the_kernel_contract(reacher_case, monkeypatch,
                                                 contract):
    """On a CUDA device an env with the contract gets the kernel objective
    (with the agent's risk knobs), one without it the eager objective;
    building either touches no device and calls no closure."""
    from ppi_tpu_torch.mpc import agent as agent_mod
    env = reacher_case[0] if contract else _NoContract()
    seen = []

    def spy(kind):
        def build(*args, **kwargs):
            seen.append((kind, kwargs))

            def f(generator, actions):
                raise AssertionError("the objective was called")
            return f
        return build

    monkeypatch.setattr(agent_mod, "kernel_mpc_objective", spy("kernel"))
    monkeypatch.setattr(agent_mod, "mpc_objective", spy("eager"))
    agent = _agent(reacher_case[0], "cuda", risk_weight=0.5)
    agent = dataclasses.replace(agent, env=env)
    # the mask stays on the host: no card here
    monkeypatch.setattr(Mpc, "horizon_mask",
                        lambda self, t: torch.ones(self.horizon))
    agent.objective(reacher_case[1], 0)
    assert [k for k, _ in seen] == ["kernel" if contract else "eager"]
    assert seen[0][1] == dict(risk_quantile=1.0, risk_weight=0.5)
