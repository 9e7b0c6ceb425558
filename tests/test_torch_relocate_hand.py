"""relocate-v0-hand: the port's env and rollout against the JAX package.

The JAX reference is ``RelocateHand(engine="tensor")``, the JAX package's
CPU test engine (its scalar program takes tens of minutes to compile on
the CPU at 13 DoF). The first half of the lanes starts from the reset
posture with the ball resting on the table (the table contact); in the
second half the ball starts 7 cm up, inside the open hand, whose digits
and palm push it sideways (the digit contacts) and hold it above the lift
gate. The goals are relocate-v0's pinned ones, more than 0.25 from the
ball, so the proximity bonuses cannot switch. Tolerances: rewards 1e-6,
positions 1e-6, velocities 1e-5, absolute and relative (the tensor engine
assembles the same dynamics in another order): measured 3.0e-7, 4.8e-7
and 7.3e-6 at N=8, H=4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    assert_hand_torque_matches, assert_host_c_matches_plain,
    assert_kernel_step_is_the_eager_step, assert_model_equals_reference,
    assert_nan_lane_goes_nan_alone, assert_objective_costs_match,
    assert_observe_and_success_match, assert_step_rollout_matches,
    jax_lane_rollout_fn, port_state, run_on_cpu, wrapper_run)
from torch_helpers import to_np
from ppi_tpu.envs.relocate_hand import RelocateHand as JaxRelocateHand
from ppi_tpu_torch.envs.relocate import (
    GOAL_X, GOAL_Y, GOAL_Z, LIFT_Z, START_RANGE, TABLE_Z, BALL_RADIUS)
from ppi_tpu_torch.envs.relocate_hand import (
    BALL_X, BALL_Y, BALL_Z, N_ACT, RelocateHand, RelocateHandState)

N, H = 8, 4
GOALS = {"a": (0.55, 0.15, 0.85), "b": (0.65, 0.10, 0.88)}
TOL = dict(rtol=1e-6, atol=1e-6)
VEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[1], ref[1], **TOL)
    np.testing.assert_allclose(got[2], ref[2], **VEL_TOL)


@pytest.fixture(scope="module")
def jenv():
    return JaxRelocateHand(engine="tensor")


@pytest.fixture(scope="module")
def lanes(jenv):
    """(q0, qd0, actions): the ball on the table, then in the hand."""
    q = np.asarray(jenv.reset(jax.random.key(0)).physics.qpos).copy()
    q[BALL_X], q[BALL_Y] = 0.02, -0.03
    q0 = np.tile(q, (N, 1))
    q0[N // 2:, BALL_Z] = 0.07
    acts = (q0[:, None, :N_ACT] + 0.3 * np.random.default_rng(0)
            .standard_normal((N, H, N_ACT))).astype(np.float32)
    return q0, np.zeros_like(q0), acts


@pytest.fixture(scope="module")
def reference(jenv, lanes):
    """{goal: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    run = jax_lane_rollout_fn(jenv)
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, goal in GOALS.items():
        js = s0.replace(target=jnp.asarray(goal, jnp.float32))
        out[name] = (js, run(js, *lanes))
    return out


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, RelocateHand())


def test_reset_goal_and_start_match_reference(jenv):
    js = jenv.reset(jax.random.key(3))
    start = np.asarray(js.physics.qpos)[[BALL_X, BALL_Y]]
    s = RelocateHand().reset(None, "cpu", goal=np.asarray(js.target),
                             start=start)
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.target), np.asarray(js.target))
    ps = port_state(RelocateHandState, js)
    np.testing.assert_array_equal(to_np(ps.target), np.asarray(js.target))
    a, b = (RelocateHand().reset(torch.Generator().manual_seed(k), "cpu")
            for k in (1, 2))
    assert not torch.allclose(a.target, b.target)
    lo = np.array([GOAL_X[0], GOAL_Y[0], GOAL_Z[0]], np.float32)
    hi = np.array([GOAL_X[1], GOAL_Y[1], GOAL_Z[1]], np.float32)
    for s in (a, b):
        assert np.all(to_np(s.target) >= lo) and np.all(to_np(s.target) <= hi)
        assert np.all(np.abs(to_np(s.physics.qpos)[[BALL_X, BALL_Y]])
                      <= START_RANGE)
    fixed = RelocateHand(fixed_goal=True).reset(None, "cpu")
    jfixed = JaxRelocateHand(engine="tensor", fixed_goal=True).reset(
        jax.random.key(0))
    np.testing.assert_array_equal(to_np(fixed.target),
                                  np.asarray(jfixed.target))
    np.testing.assert_array_equal(to_np(fixed.physics.qpos),
                                  np.asarray(jfixed.physics.qpos))


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, RelocateHand())


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_plain_rollout_matches_reference(reference, lanes, goal):
    js, ref = reference[goal]
    q0, qd0, acts = lanes
    _close(wrapper_run(RelocateHand(), port_state(RelocateHandState, js),
                       acts, q0, qd0), ref)


def test_the_hand_pushes_the_ball_it_holds(reference, lanes):
    """The ball in the hand is moved sideways by the digits and some lanes
    keep it above the lift gate; the ball on the table stays put."""
    rew, qf, _ = reference["a"][1]
    moved = np.abs(qf[:, [BALL_X, BALL_Y]] - lanes[0][:, [BALL_X, BALL_Y]]
                   ).max(1)
    assert np.all(moved[N // 2:] > 0.02) and np.all(moved[:N // 2] < 0.01)
    ball_z = TABLE_Z + BALL_RADIUS + qf[:, BALL_Z]
    assert np.sum(ball_z > LIFT_Z) >= 2 and np.sum(ball_z < LIFT_Z) >= 4
    assert rew[ball_z > LIFT_Z, -1].min() > 0.5   # the lift gate's term


def test_goals_change_the_rewards_not_the_dynamics(reference):
    """The goal enters the reward behind the lift gate: the lanes whose
    ball stays on the table are paid the same under both goals."""
    (ra, qa, _), (rb, qb, _) = reference["a"][1], reference["b"][1]
    np.testing.assert_array_equal(qa, qb)
    np.testing.assert_array_equal(ra[:N // 2], rb[:N // 2])
    assert np.all(np.abs(ra.sum(1) - rb.sum(1))[N // 2:] > 1e-2)
    # no proximity bonus (+10/+20) in any step
    assert np.all(np.abs(ra) < 4.0) and np.all(np.abs(rb) < 4.0)


def test_step_over_lanes_matches_reference(reference, lanes):
    js, ref = reference["a"]
    assert_step_rollout_matches(RelocateHand(),
                                port_state(RelocateHandState, js), *lanes,
                                ref)


def test_kernel_step_on_cpu_is_the_eager_step(reference, lanes):
    q0, _, acts = lanes
    assert_kernel_step_is_the_eager_step(
        RelocateHand(), port_state(RelocateHandState, reference["b"][0]),
        q0[5], acts[5, 0])


def test_kernel_objective_costs_match_reference(jenv, reference, lanes):
    js = reference["b"][0]
    q = np.tile(np.asarray(js.physics.qpos), (N, 1))
    rew, _, _ = jax_lane_rollout_fn(jenv)(js, q, np.zeros_like(q), lanes[2])
    assert_objective_costs_match(RelocateHand(),
                                 port_state(RelocateHandState, js), lanes[2],
                                 rew)


def test_nan_lane_goes_nan_alone(reference, lanes):
    q0, qd0, acts = lanes
    assert_nan_lane_goes_nan_alone(
        RelocateHand(), port_state(RelocateHandState, reference["a"][0]),
        acts, q0, qd0)


def test_observe_and_success_match_reference(jenv, reference):
    js = reference["a"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    # the ball carried to within 0.1 of goal a
    qpos[BALL_X], qpos[BALL_Y], qpos[BALL_Z] = -0.03, 0.12, 0.2
    carried = js.replace(physics=js.physics.replace(qpos=jnp.asarray(qpos)))
    assert_observe_and_success_match(jenv, RelocateHand(), RelocateHandState,
                                     [(js, False), (carried, True)])


def test_host_c_build_matches_plain(reference, lanes):
    """The 13-DoF body with reward constants, as host C, on table, grasp
    and NaN lanes."""
    q0, qd0, acts = lanes
    bad = q0.copy()
    bad[1, 0] = np.nan
    assert_host_c_matches_plain(
        RelocateHand(), port_state(RelocateHandState, reference["b"][0]),
        acts[:, :3], bad, qd0)


def test_runner_runs_relocate_hand_on_cpu():
    run_on_cpu(["Mppi", "relocate-v0-hand", "ColouredNoise", "--beta", "2",
                "--alpha", "10", "--anneal", "0.9"], N_ACT)
