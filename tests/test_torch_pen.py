"""pen-v0: the port's env and rollout against the JAX package.

Two pinned goal axes, both with a similarity below 0.6 to the reset axis
(1, 0, 0), so the +10 and +50 bonuses (similarity 0.90 and 0.95) cannot
switch within H=3 and one ulp cannot move a reward by 10. Tolerances are
tests/test_torch_rollout.py's (tests/torch_env_helpers.py). The T=3 MPC
comparison holds the first action to 5e-4, as tests/test_torch_mpc.py does
for door-v0 (LBPS temperature near-ties, ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    REW_TOL, assert_host_c_matches_plain, assert_model_equals_reference,
    assert_rollout_close, assert_steps_through_env_step, jax_rollout_fn,
    port_state, wrapper_run)
from torch_helpers import to_np, to_torch
import ppi_tpu.policies.primitives as jax_primitives
import ppi_tpu_torch.policies.primitives as primitives
from ppi_tpu.algorithms import make_solver as jax_make_solver
from ppi_tpu.envs.pen import Pen as JaxPen
from ppi_tpu.envs.pen import axis_from_angles as jax_axis_from_angles
from ppi_tpu.mpc import Mpc as JaxMpc
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.envs.base import batch_rollout
from ppi_tpu_torch.envs.pen import Pen, PenState, axis_from_angles
from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_mpc_objective
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.policies import design_moments, make_policy
from ppi_tpu_torch.runners import run_mpc

N, H = 12, 3
GOALS = {"a": (0.9, -0.6), "b": (-0.95, 0.5)}  # (yaw, pitch) in U(-1, 1)
NAN_LANE = 3


@pytest.fixture(scope="module")
def acts():
    return (0.12 * np.random.default_rng(0).standard_normal(
        (N, H, 4))).astype(np.float32)


@pytest.fixture(scope="module")
def reference(acts):
    """{goal: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    jenv = JaxPen()
    run = jax_rollout_fn(jenv)
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, (yaw, pitch) in GOALS.items():
        js = s0.replace(target_axis=jax_axis_from_angles(yaw, pitch))
        out[name] = (js, run(js, acts))
    return out


def test_model_matches_reference():
    assert_model_equals_reference(JaxPen(), Pen())


def test_reset_and_goal_axis_match_reference():
    js = JaxPen().reset(jax.random.key(0))
    axis = np.asarray(jax_axis_from_angles(*GOALS["a"]))
    s = Pen().reset(None, "cpu", goal=axis)
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.target_axis), axis)
    np.testing.assert_allclose(to_np(axis_from_angles(*GOALS["a"])), axis,
                               rtol=1e-6, atol=1e-7)
    sampled = Pen().reset(torch.Generator().manual_seed(0), "cpu")
    assert abs(float(torch.linalg.norm(sampled.target_axis)) - 1.0) < 1e-6
    fixed = Pen(fixed_goal=True).reset(None, "cpu")
    np.testing.assert_allclose(to_np(fixed.target_axis), np.asarray(
        JaxPen(fixed_goal=True).reset(jax.random.key(0)).target_axis),
        rtol=1e-6, atol=1e-7)


def test_goals_are_away_from_the_bonus_thresholds(reference):
    for name, (js, (rew, _, _)) in reference.items():
        similarity = float(np.asarray(js.target_axis)[0])  # axis . (1,0,0)
        assert similarity < 0.6, name
        # no aligned bonus (+10/+50) and no drop (-5) in any step
        assert np.all(np.abs(rew) < 4.0), name


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_plain_rollout_matches_reference(reference, acts, goal):
    js, ref = reference[goal]
    assert_rollout_close(wrapper_run(Pen(), port_state(PenState, js), acts),
                         ref)


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_batch_rollout_matches_reference(reference, acts, goal):
    """The port's eager env step over N lanes."""
    js, ref = reference[goal]
    final, rew = batch_rollout(Pen(), port_state(PenState, js),
                               to_torch(acts))
    assert_rollout_close((to_np(rew), to_np(final.physics.qpos),
                          to_np(final.physics.qvel)), ref)
    assert int(final.t) == H


def test_real_step_goes_through_env_step(reference, acts):
    """``step`` is ``rollout_kernel.env_step``: one launch of the kernel
    on a CUDA state; on the CPU the eager step that the batch rollout above
    holds to the JAX env's step."""
    js, _ = reference["b"]
    assert_steps_through_env_step(Pen(), port_state(PenState, js),
                                  np.asarray(js.physics.qpos), acts[5, 0])


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_kernel_objective_costs_match_reference(reference, acts, goal):
    js, (rew, _, _) = reference[goal]
    s = port_state(PenState, js)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    costs = kernel_mpc_objective(Pen(), s, H)(None, to_torch(acts))
    masked = kernel_mpc_objective(Pen(), s, H, to_torch(mask))(
        None, to_torch(acts))
    np.testing.assert_allclose(to_np(costs), -rew.sum(1), **REW_TOL)
    np.testing.assert_allclose(to_np(masked), -(rew * mask).sum(1),
                               **REW_TOL)


def test_goals_change_the_costs(reference, acts):
    costs = [to_np(kernel_mpc_objective(
        Pen(), port_state(PenState, reference[g][0]), H)(
            None, to_torch(acts))) for g in sorted(GOALS)]
    assert np.all(np.abs(costs[0] - costs[1]) > 1e-3)


def test_nan_lane_goes_nan_alone(reference, acts):
    s = port_state(PenState, reference["a"][0])
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[NAN_LANE, 3] = np.nan
    rew, _, _ = wrapper_run(Pen(), s, acts, q0=q0)
    clean, _, _ = wrapper_run(Pen(), s, acts)
    assert np.isnan(rew[NAN_LANE]).all()
    keep = np.arange(N) != NAN_LANE
    np.testing.assert_array_equal(rew[keep], clean[keep])


def test_host_c_build_matches_plain(reference):
    """The reward-constants variant of the kernel body, as host C."""
    s = port_state(PenState, reference["b"][0])
    rng = np.random.default_rng(2)
    n, h = 7, 3
    acts = (0.12 * rng.standard_normal((n, h, 4))).astype(np.float32)
    q0 = np.tile(to_np(s.physics.qpos), (n, 1))
    q0[5, 0] = np.nan
    qd0 = (0.05 * rng.standard_normal(q0.shape)).astype(np.float32)
    assert_host_c_matches_plain(Pen(), s, acts, q0, qd0)


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_routed_split_build_matches_reference(reference, acts, goal):
    """pen-v0 routes to the split layout with its pen's chain cut into
    segments: that body built as host C against ``ppi_tpu``'s rollout on
    the same numpy inputs, at each goal, within the rollout tolerances."""
    from test_torch_warp_layout import _host_run, _needs_cc
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    _needs_cc()
    env = Pen()
    js, ref = reference[goal]
    s = port_state(PenState, js)
    assert (rk.kernel_layout(env), rk.split_partition(env)) == (
        "split", "chain")
    run = rk.load_host_split_rollout(rk.generate_split_header(
        *rk.body_args(env, s), partition=rk.split_partition(env)))
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    qd0 = np.tile(to_np(s.physics.qvel), (N, 1))
    assert_rollout_close(_host_run(run, env, s, q0, qd0, acts), ref)


def test_observe_and_success_match_reference(reference):
    jenv, env = JaxPen(), Pen()
    js = reference["a"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[3], qpos[4] = 0.9, -0.6   # the pen turned onto goal a
    for q, want in ((np.asarray(js.physics.qpos), False), (qpos, True)):
        jst = js.replace(physics=js.physics.replace(qpos=jnp.asarray(q)))
        st = port_state(PenState, jst)
        np.testing.assert_allclose(to_np(env.observe(st)),
                                   np.asarray(jenv.observe(jst)), rtol=1e-5,
                                   atol=1e-6)
        assert bool(env.success(st)) == bool(jenv.success(jst)) == want


# ---- the slice as a whole: a T=3 pen MPC episode against the JAX agent -----

MPC_N, MPC_H, MPC_T = 16, 6, 3


def _mpc_episodes():
    z = np.random.default_rng(0).standard_normal((MPC_N, MPC_H * 4)).astype(
        np.float32)
    jenv = JaxPen(fixed_goal=True)
    jm, jci, jco = jax_design_moments(jenv.action_low, jenv.action_high,
                                      1000.0)
    jfam, jpol = jax_make_policy(
        "SquaredExponentialKernel", jenv.dt * jnp.arange(MPC_H), 4, jm, jci,
        jco, lengthscale=0.08, lower=jenv.action_low,
        upper=jenv.action_high)
    jagent = JaxMpc(env=jenv, solver=jax_make_solver("Lbps", delta=0.9),
                    family=jfam, timesteps=MPC_T, horizon=MPC_H,
                    n_samples=MPC_N, n_iters=2, anneal=0.5, use_pallas=False)
    env = Pen()
    m, ci, co = design_moments(env.action_low, env.action_high, 1000.0)
    fam, pol = make_policy(
        "SquaredExponentialKernel", env.dt * torch.arange(MPC_H), 4, m, ci,
        co, lengthscale=0.08, lower=env.action_low, upper=env.action_high,
        device="cpu")
    agent = Mpc(env=env, solver=make_solver("Lbps", delta=0.9), family=fam,
                timesteps=MPC_T, horizon=MPC_H, n_samples=MPC_N, n_iters=2,
                anneal=0.5, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_primitives, "draw_base",
                   lambda kind, key, n, dim: jnp.asarray(z))
        mp.setattr(primitives, "draw_base",
                   lambda kind, gen, n, dim, device: to_torch(z))
        jcarry = jagent.init(jpol, jax.random.key(0))
        js = jenv.reset(jax.random.key(0))
        jcarry, _ = jagent.warm_start(jcarry, js, 2)
        _, jfinal, jtrack = jagent.run_episode(jcarry, js)
        carry = agent.init(pol, torch.Generator().manual_seed(0))
        s = env.reset(None, "cpu", goal=np.asarray(js.target_axis))
        carry, _ = agent.warm_start(carry, s, 2)
        _, final, track = agent.run_episode(carry, s)
    return (jtrack, jfinal), (track, final)


@pytest.fixture(scope="module")
def episodes():
    return _mpc_episodes()


def test_mpc_first_action_matches_reference(episodes):
    (jtrack, _), (track, _) = episodes
    np.testing.assert_allclose(to_np(track["action"][0]),
                               np.asarray(jtrack["action"][0]), atol=5e-4)


def test_mpc_episode_matches_reference(episodes):
    (jtrack, jfinal), (track, final) = episodes
    assert track["action"].shape == (MPC_T, 4)
    np.testing.assert_allclose(to_np(track["action"]),
                               np.asarray(jtrack["action"]), atol=5e-4)
    np.testing.assert_allclose(to_np(track["reward"]),
                               np.asarray(jtrack["reward"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(final.physics.qpos),
                               np.asarray(jfinal.physics.qpos), atol=1e-3)
    np.testing.assert_allclose(to_np(track["obs"]), np.asarray(jtrack["obs"]),
                               atol=1e-3)


def test_runner_runs_pen_on_cpu():
    args = run_mpc.build_parser().parse_args([
        "Lbps", "pen-v0", "SquaredExponentialKernel", "--delta", "0.9",
        "--n-iters", "2", "--anneal", "0.5", "--lengthscale", "0.08",
        "--horizon", "4", "--timesteps", "2", "--n-warmstart-iters", "1",
        "--device", "cpu", "MonteCarlo", "--n-samples", "8"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success in (True, False)
    assert track["action"].shape == (2, 4)
    assert bool(torch.isfinite(track["obs"]).all())
