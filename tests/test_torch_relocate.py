"""relocate-v0: the port's env and rollout against the JAX package.

Two pinned (goal, ball start) pairs, each goal more than 0.2 from the ball,
so the +10 and +20 carry bonuses (ball within 0.1 and 0.05 of the goal)
cannot switch within H=3. In case "a" the ball rests on the table, 0.015
below the lift gate; in case "b" it starts 0.1 above the table, clear of
the gripper, and falls freely through the three steps, well above the
gate, so the goal enters the reward through the lifted carry terms.
Tolerances are tests/test_torch_rollout.py's (tests/torch_env_helpers.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    REW_TOL, assert_model_equals_reference, assert_rollout_close,
    assert_steps_through_env_step, jax_rollout_fn, port_state, wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.relocate import Relocate as JaxRelocate
from ppi_tpu_torch.envs.base import batch_rollout
from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_mpc_objective
from ppi_tpu_torch.envs.relocate import (
    BALL_START, BALL_X, BALL_Z, LIFT_Z, TABLE_Z, BALL_RADIUS, Relocate,
    RelocateState)
from ppi_tpu_torch.runners import run_mpc

N, H = 12, 3
CASES = {  # (goal, ball start offset (x, y, z) from its rest position)
    "a": ((0.55, 0.15, 0.85), (0.04, 0.03, 0.0)),
    "b": ((0.65, 0.10, 0.88), (0.0, -0.15, 0.1)),
}
NAN_LANE = 7


@pytest.fixture(scope="module")
def acts():
    return (0.1 * np.random.default_rng(0).standard_normal(
        (N, H, 6))).astype(np.float32)


def _jax_state(jenv, goal, start):
    js = jenv.reset(jax.random.key(0))
    qpos = js.physics.qpos.at[BALL_X:].set(jnp.asarray(start))
    return js.replace(physics=js.physics.replace(qpos=qpos),
                      target=jnp.asarray(goal, jnp.float32))


@pytest.fixture(scope="module")
def reference(acts):
    """{case: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    jenv = JaxRelocate()
    run = jax_rollout_fn(jenv)
    out = {}
    for name, (goal, start) in CASES.items():
        js = _jax_state(jenv, goal, start)
        out[name] = (js, run(js, acts))
    return out


def test_model_matches_reference():
    assert_model_equals_reference(JaxRelocate(), Relocate())


def test_reset_with_pinned_goal_and_start_matches_reference():
    goal, start = CASES["a"]
    js = _jax_state(JaxRelocate(), goal, start)
    s = Relocate().reset(None, "cpu", goal=goal, start=start[:2])
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.target), np.asarray(js.target))
    sampled = Relocate().reset(torch.Generator().manual_seed(0), "cpu")
    lo = np.array([0.50, -0.20, TABLE_Z + 0.15], np.float32)
    hi = np.array([0.68, 0.20, TABLE_Z + 0.30], np.float32)
    g = to_np(sampled.target)
    assert np.all(g >= lo) and np.all(g <= hi)
    assert np.all(np.abs(to_np(sampled.physics.qpos[BALL_X:BALL_Z])) <= 0.05)
    fixed = Relocate(fixed_goal=True).reset(None, "cpu")
    np.testing.assert_allclose(to_np(fixed.target), np.asarray(
        JaxRelocate(fixed_goal=True).reset(jax.random.key(0)).target))


def test_goals_are_away_from_the_bonus_thresholds(reference):
    for name, (goal, start) in CASES.items():
        ball = np.array([BALL_START[0], BALL_START[1],
                         TABLE_Z + BALL_RADIUS]) + np.array(start)
        assert np.linalg.norm(ball - np.array(goal)) > 0.2, name
        _, (rew, qf, _) = reference[name]
        assert np.all(np.abs(rew) < 5.0), name       # no +10/+20 bonus
        ball_z = TABLE_Z + BALL_RADIUS + qf[:, BALL_Z]
        if name == "a":   # on the table, below the lift gate
            assert np.all(ball_z < LIFT_Z - 0.01), name
        else:             # falling freely, above it
            assert np.all(ball_z > LIFT_Z + 0.05), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_rollout_matches_reference(reference, acts, case):
    js, ref = reference[case]
    assert_rollout_close(
        wrapper_run(Relocate(), port_state(RelocateState, js), acts), ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_rollout_matches_reference(reference, acts, case):
    """The port's eager env step over N lanes."""
    js, ref = reference[case]
    final, rew = batch_rollout(Relocate(), port_state(RelocateState, js),
                               to_torch(acts))
    assert_rollout_close((to_np(rew), to_np(final.physics.qpos),
                          to_np(final.physics.qvel)), ref)


def test_real_step_goes_through_env_step(reference, acts):
    """``step`` is ``rollout_kernel.env_step``: one launch of the kernel
    on a CUDA state; on the CPU the eager step that the batch rollout above
    holds to the JAX env's step."""
    js, _ = reference["b"]
    assert_steps_through_env_step(
        Relocate(), port_state(RelocateState, js),
        np.asarray(js.physics.qpos), acts[5, 0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_objective_costs_match_reference(reference, acts, case):
    js, (rew, _, _) = reference[case]
    costs = kernel_mpc_objective(
        Relocate(), port_state(RelocateState, js), H)(None, to_torch(acts))
    np.testing.assert_allclose(to_np(costs), -rew.sum(1), **REW_TOL)


def test_goals_change_the_costs(reference, acts):
    """The same lifted start under both goals: only the reward constants
    differ."""
    js = reference["b"][0]
    other = js.replace(target=reference["a"][0].target)
    costs = [to_np(kernel_mpc_objective(
        Relocate(), port_state(RelocateState, s), H)(None, to_torch(acts)))
        for s in (js, other)]
    assert np.all(np.abs(costs[0] - costs[1]) > 1e-3)


def test_nan_lane_goes_nan_alone(reference, acts):
    s = port_state(RelocateState, reference["b"][0])
    qd0 = np.zeros((N, 9), np.float32)
    qd0[NAN_LANE, 8] = np.inf
    rew, _, _ = wrapper_run(Relocate(), s, acts, qd0=qd0)
    clean, _, _ = wrapper_run(Relocate(), s, acts)
    assert np.isnan(rew[NAN_LANE]).all()
    keep = np.arange(N) != NAN_LANE
    np.testing.assert_array_equal(rew[keep], clean[keep])


def test_observe_and_success_match_reference(reference):
    jenv, env = JaxRelocate(), Relocate()
    js = reference["a"][0]
    goal, start = CASES["a"]
    qpos = np.asarray(js.physics.qpos).copy()
    # the ball carried onto the goal
    qpos[BALL_X] = goal[0] - BALL_START[0]
    qpos[BALL_X + 1] = goal[1] - BALL_START[1]
    qpos[BALL_Z] = goal[2] - TABLE_Z - BALL_RADIUS
    for q, want in ((np.asarray(js.physics.qpos), False), (qpos, True)):
        jst = js.replace(physics=js.physics.replace(qpos=jnp.asarray(q)))
        st = port_state(RelocateState, jst)
        np.testing.assert_allclose(to_np(env.observe(st)),
                                   np.asarray(jenv.observe(jst)), rtol=1e-5,
                                   atol=1e-6)
        assert bool(env.success(st)) == bool(jenv.success(jst)) == want


def test_runner_runs_relocate_on_cpu():
    args = run_mpc.build_parser().parse_args([
        "Mppi", "relocate-v0", "ColouredNoise", "--beta", "2", "--alpha",
        "10", "--anneal", "0.9", "--horizon", "4", "--timesteps", "2",
        "--n-warmstart-iters", "1", "--device", "cpu", "MonteCarlo",
        "--n-samples", "8"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success in (True, False)
    assert track["action"].shape == (2, 6)
    assert bool(torch.isfinite(track["obs"]).all())
