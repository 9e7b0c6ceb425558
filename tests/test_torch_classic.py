"""The classic envs (``envs/classic.py``): Pendulum and Cartpole against the
JAX package on the same numpy inputs, their eager MPC objective, the
``broadcast_state`` path for a state without ``physics``, and the runner's
23 envs.

Tolerances. A step is a few float32 operations, so one step agrees to an
ulp or two; over 50 steps of one action array 1e-5 (relative and
absolute) on the coordinates and rewards: torch's and XLA's sin/cos differ
in the last bit for some inputs, and pendulum swing-ups amplify that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.base import batch_rollout as jax_batch_rollout
from ppi_tpu.envs.base import mpc_objective as jax_mpc_objective
from ppi_tpu.envs.classic import Cartpole as JaxCartpole
from ppi_tpu.envs.classic import Pendulum as JaxPendulum
from ppi_tpu_torch.convert import classic_state_from_numpy
from ppi_tpu_torch.envs.base import (
    _finite_lanes, batch_rollout, broadcast_state, mpc_objective)
from ppi_tpu_torch.envs.classic import Cartpole, ClassicState, Pendulum
from ppi_tpu_torch.runners import run_mpc

ENVS = {"pendulum": (Pendulum, JaxPendulum), "cartpole": (Cartpole,
                                                         JaxCartpole)}
STEPS = 50
TOL = 1e-5


def _actions(name, n, h, seed):
    """Actions past the box on both sides, so the clip is exercised."""
    scale = 3.0 if name == "pendulum" else 15.0
    return (scale * np.random.default_rng(seed).standard_normal(
        (n, h, 1))).astype(np.float32)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_steps_match_jax_over_50_steps(name):
    """50 steps of one action array from four starts (the reset's and three
    others, negative angles among them: ``jnp.mod`` is floored, as
    ``torch.remainder``), lane by lane."""
    cls, jcls = ENVS[name]
    env, jenv = cls(), jcls()
    rng = np.random.default_rng(1)
    nq = 1 if name == "pendulum" else 2
    qpos = np.concatenate([np.asarray(jenv.reset(None).qpos)[None],
                           rng.uniform(-4.0, 4.0, (3, nq))]).astype(
                               np.float32)
    qvel = np.concatenate([np.zeros((1, nq)),
                           rng.standard_normal((3, nq))]).astype(np.float32)
    acts = _actions(name, 4, STEPS, 2)
    state = classic_state_from_numpy(dict(qpos=qpos, qvel=qvel), "cpu")
    jstep = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0)))
    from ppi_tpu.envs.classic import ClassicState as JaxState
    jstate = JaxState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                      t=jnp.zeros(4, jnp.int32))
    for k in range(STEPS):
        state, r = env.step(state, to_torch(acts[:, k]))
        jstate, jr = jstep(jstate, jnp.asarray(acts[:, k]))
        np.testing.assert_allclose(to_np(r), np.asarray(jr), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(to_np(state.qpos), np.asarray(jstate.qpos),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(state.qvel), np.asarray(jstate.qvel),
                               rtol=TOL, atol=TOL)
    assert int(state.t) == STEPS


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_and_observe_match_jax(name):
    cls, jcls = ENVS[name]
    env, jenv = cls(), jcls()
    s, js = env.reset(None, "cpu"), jenv.reset(jax.random.key(0))
    np.testing.assert_array_equal(to_np(s.qpos), np.asarray(js.qpos))
    np.testing.assert_array_equal(to_np(s.qvel), np.asarray(js.qvel))
    np.testing.assert_allclose(to_np(env.observe(s)),
                               np.asarray(jenv.observe(js)), atol=1e-7)
    np.testing.assert_array_equal(to_np(env.action_low),
                                  np.asarray(jenv.action_low))
    np.testing.assert_array_equal(to_np(env.action_high),
                                  np.asarray(jenv.action_high))


def test_wrap_is_floored_not_truncated():
    """At -0.5 rad the floored wrap (``jnp.mod``, ``torch.remainder``)
    gives the angle itself; ``torch.fmod`` would give -0.5 + 2 pi - 2 pi
    shifted by a whole turn for ``th + pi < 0``."""
    env = Pendulum()
    for th in (-0.5, -4.0, 4.0):
        s = ClassicState(qpos=torch.tensor([th]), qvel=torch.zeros(1),
                         t=torch.zeros((), dtype=torch.int32))
        js = JaxPendulum().reset(None).replace(qpos=jnp.array([th]))
        _, r = env.step(s, torch.zeros(1))
        _, jr = JaxPendulum().step(js, jnp.zeros(1))
        np.testing.assert_allclose(float(r), float(jr), rtol=TOL)


def test_broadcast_state_takes_a_state_without_physics():
    """The repair: ``broadcast_state`` gives a ``ClassicState``'s own
    ``qpos`` and ``qvel`` the lanes (before, it read ``state.physics`` and
    raised); ``t``, an int, is not a lane field of ``_finite_lanes``."""
    s = Pendulum().reset(None, "cpu")
    b = broadcast_state(s, 3)
    assert b.qpos.shape == (3, 1) and b.qvel.shape == (3, 1)
    assert b.t.shape == ()
    assert bool(_finite_lanes(b, 3).all())
    bad = ClassicState(qpos=torch.tensor([[0.0], [np.nan], [1.0]]),
                       qvel=torch.zeros(3, 1), t=b.t)
    assert _finite_lanes(bad, 3).tolist() == [True, False, True]
    # t at n = 1 is still no lane field
    one = broadcast_state(s, 1)
    assert _finite_lanes(one, 1).tolist() == [True]


@pytest.mark.parametrize("name", sorted(ENVS))
def test_mpc_objective_matches_jax(name):
    """The eager objective and ``batch_rollout`` from the reset state, N=8,
    H=12, one NaN lane (it poisons only itself)."""
    cls, jcls = ENVS[name]
    env, jenv = cls(), jcls()
    acts = _actions(name, 8, 12, 3)
    acts[5, 4, 0] = np.nan
    s0, js0 = env.reset(None, "cpu"), jenv.reset(None)
    costs = mpc_objective(env, s0)(None, to_torch(acts))
    jcosts = jax_mpc_objective(jenv, js0)(None, jnp.asarray(acts))
    np.testing.assert_allclose(to_np(costs), np.asarray(jcosts), rtol=TOL,
                               atol=TOL)
    assert np.isnan(to_np(costs)[5]) and np.isfinite(
        np.delete(to_np(costs), 5)).all()
    final, rewards = batch_rollout(env, s0, to_torch(acts))
    jfinal, jrewards = jax_batch_rollout(jenv, js0, jnp.asarray(acts))
    np.testing.assert_allclose(to_np(rewards), np.asarray(jrewards),
                               rtol=TOL, atol=TOL)
    assert final.qpos.shape == (8, 1 if name == "pendulum" else 2)


def test_runner_has_the_jax_runners_23_envs():
    from ppi_tpu.runners.run_mpc import ENVS as JAX_ENVS
    assert sorted(run_mpc.ENVS) == sorted(JAX_ENVS)
    assert len(run_mpc.ENVS) == 23
    assert set(run_mpc.EAGER_ENVS) == {"pendulum", "cartpole"}
    assert set(run_mpc.ENVS) == set(run_mpc.EAGER_ENVS) | set(
        run_mpc.KERNEL_ENVS)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_runner_episode_on_the_cpu(name):
    """A short Mppi episode through the runner (the eager objective: these
    envs have no kernel contract); no physics row in the track."""
    args = run_mpc.build_parser().parse_args(
        ["Mppi", name, "WhiteNoiseIid", "--timesteps", "4", "--horizon",
         "6", "--n-warmstart-iters", "2", "--device", "cpu", "MonteCarlo",
         "--n-samples", "16"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success is None
    assert track["action"].shape == (4, 1) and "qpos" not in track
    assert track["obs"].shape == (4, 3 if name == "pendulum" else 5)
