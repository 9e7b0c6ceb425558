"""The episodic envs (``envs/episodic.py``) against the JAX package's: the
Test env's evaluation and its search to convergence, ``BallInACup``'s
interface, the canonical prior's conditioning (the jitter-free Gram that
the ball-in-a-cup search conditions on), and ``_finite_lanes`` on a
ball-in-a-cup state.

Tolerances. The Test env's costs: 1e-6 relative (a mean of squares in
another summation order). The conditioned prior: 1e-4 of the largest
entry (torch's and XLA's float32 inverses and Cholesky factors of the
21 x 21 Gram; a Cholesky factor is held through L L^T).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.episodic import EPISODIC_ENVS as JAX_EPISODIC_ENVS
from ppi_tpu.envs.episodic import BallInACup as JaxBallInACup
from ppi_tpu.envs.episodic import TestEnv as JaxTestEnv
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.algorithms import make_solver, solve
from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
from ppi_tpu_torch.envs.base import _finite_lanes
from ppi_tpu_torch.envs.episodic import EPISODIC_ENVS, BallInACup, TestEnv
from ppi_tpu_torch.policies import make_policy

Q_START = torch.tensor([0.0, 0.0, 0.0, 1.5707])


def _prior(env, device="cpu"):
    """The canonical prior of run_policy_search and the JAX package's
    tests/test_episodic.py, conditioned where the env asks."""
    fam, pol = make_policy(
        "RbfFeatures", env.t, env.dim_action, env.action_0,
        covariance_in=torch.tensor([1e2]),
        covariance_out=torch.diag(torch.tensor([1e-3] * env.dim_action)),
        lengthscale=float(np.sqrt(3e-2)), n_features=20,
        use_derivatives=True, add_bias=True, device=device)
    if env.condition:
        pol = fam.condition(pol, torch.zeros(1), env.action_0[None, :])
    return fam, pol


def _jax_prior(env):
    fam, pol = jax_make_policy(
        "RbfFeatures", env.t, env.dim_action, env.action_0,
        covariance_in=jnp.array([1e2]),
        covariance_out=jnp.diag(jnp.array([1e-3] * env.dim_action)),
        lengthscale=float(np.sqrt(3e-2)), n_features=20,
        use_derivatives=True, add_bias=True)
    if env.condition:
        pol = fam.condition(pol, jnp.zeros(1), env.action_0[None, :])
    return fam, pol


def test_test_env_evaluates_as_jax():
    env, jenv = TestEnv(), JaxTestEnv()
    acts = np.random.default_rng(0).standard_normal((6, 100, 4)).astype(
        np.float32)
    costs, succ = env.evaluate(None, to_torch(acts))
    jcosts, jsucc = jenv.evaluate(None, jnp.asarray(acts))
    np.testing.assert_allclose(to_np(costs), np.asarray(jcosts), rtol=1e-6)
    assert not bool(succ.any()) and not bool(np.asarray(jsucc).any())
    np.testing.assert_allclose(to_np(env.target("cpu")),
                               np.asarray(jenv.target), atol=1e-7)
    out = env.objective()(None, to_torch(acts))
    assert torch.equal(out[0], costs) and set(out[1]) == {"success_rate"}


def test_test_env_search_converges():
    """Reps (epsilon 2) on the Test env, 64 samples, 20 iterations: the
    mean cost falls below 0.3 of the first, the JAX test's own bar."""
    env = TestEnv()
    fam, pol = _prior(env)
    pol, trace = solve(make_solver("Reps", epsilon=2.0), fam, pol,
                       env.objective(), torch.Generator().manual_seed(0), 64,
                       20)
    assert float(trace["mean"][-1]) < 0.3 * float(trace["mean"][0])
    assert trace["success_rate"].shape == (20,)
    assert float(trace["success_rate"].max()) == 0.0


@pytest.mark.parametrize("name", ["Test", "BallInACup"])
def test_prior_conditioning_matches_jax(name):
    """The canonical prior over the env's time grid (BallInACup: 1,000
    steps; conditioned on its first action at t = 0, a jitter-free Gram
    of 20 RBF features and a bias): the mean, the input covariance and the
    Cholesky factor (through L L^T) against the JAX package's. The factor
    is finite: the Gram is PD here, off the PD edge."""
    env = EPISODIC_ENVS[name]()
    jenv = JAX_EPISODIC_ENVS[name]()
    _, pol = _prior(env)
    _, jpol = _jax_prior(jenv)
    assert env.condition == jenv.condition
    np.testing.assert_allclose(to_np(env.t), np.asarray(jenv.t), atol=1e-6)
    for field in ("mean", "cov_in"):
        a, b = to_np(getattr(pol, field)), np.asarray(getattr(jpol, field))
        assert np.max(np.abs(a - b)) <= 1e-4 * max(1.0, np.max(np.abs(b)))
    chol = pol.chol_in
    assert bool(torch.isfinite(chol).all())
    llt = to_np(chol @ chol.T)
    jchol = np.asarray(jpol.chol_in)
    assert np.max(np.abs(llt - jchol @ jchol.T)) <= 1e-4 * np.max(
        np.abs(jchol @ jchol.T))


def test_ball_in_a_cup_interface_matches_jax():
    env, jenv = BallInACup(), JaxBallInACup()
    assert (env.dim_action, env.dim_dof, env.time_horizon, env.dt) == (
        jenv.dim_action, jenv.dim_dof, jenv.time_horizon, jenv.dt)
    assert env.t.shape == (1000,) and env.action_indices == (1, 3)
    np.testing.assert_array_equal(to_np(env.action_0),
                                  np.asarray(jenv.action_0))
    np.testing.assert_array_equal(to_np(env.q_start),
                                  np.asarray(jenv.q_start))
    a = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    for x, y in zip(env.map_actions_to_joints(to_torch(a)),
                    jenv.map_actions_to_joints(jnp.asarray(a))):
        np.testing.assert_array_equal(to_np(x), np.asarray(y))
    with pytest.raises(ValueError, match="width"):
        env.evaluate(None, torch.zeros(2, 3, 2))
    assert sorted(EPISODIC_ENVS) == ["BallInACup", "Test"]
    fine = BallInACup(sim=BallInCupSim(n_particles=24))
    assert fine.sim.n_particles == 24 and env.sim.n_particles == 12


def test_rigid_string_is_not_ported_and_says_so():
    with pytest.raises(NotImplementedError,
                       match="last item of ROADMAP.md queue 1"):
        BallInACup(rigid=True)


@pytest.mark.parametrize("n", [3, 13])
def test_finite_lanes_on_a_ball_in_a_cup_state(n):
    """Every field of a batched ``BicState`` leads with the lanes (at n = 3
    and at n = 13, the particle count; no field is shared), so
    ``_finite_lanes`` reads it lane by lane. A fresh state's
    ``max_pot_m`` is -inf, which it counts as not finite, as the JAX
    package's guard does; the episodic evaluation runs no guard."""
    sim = BallInCupSim(stabilize_steps=1, cooldown_steps=1)
    fresh = sim.reset(Q_START.expand(n, 4))
    assert _finite_lanes(fresh, n).tolist() == [False] * n
    qs = Q_START.expand(n, 2, 4).clone()
    qs[1, 0, 1] = float("nan")
    final = sim.execute_trajectory(Q_START, qs, torch.zeros_like(qs))
    want = [k != 1 for k in range(n)]
    assert _finite_lanes(final, n).tolist() == want
    assert not bool(final.violated.any())
