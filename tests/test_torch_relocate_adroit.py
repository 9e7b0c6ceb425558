"""relocate-v0-adroit: the port's env and rollout against the JAX package.

The JAX reference is ``RelocateAdroit(engine="tensor")``, the JAX
package's CPU test engine (its default, "stacked", is XLA's assembly of
the same dynamics; the port runs the scalar program, whose CPU compile in
JAX is infeasible at 24 DoF), jitted once for the file. Every lane starts
from the reset posture, the open hand hovering over the ball. In the
first three the ball rests on the table (the table contact); in the next
three it slides at 2 m/s toward the thumb, which stops it (the digit
contacts); in the last two it falls from 0.1 m up, beside
the fingers and above the lift gate, where the goal enters the reward.
The goals are relocate-v0's pinned ones, more than 0.1 from the ball, so
the proximity bonuses cannot switch within H=2. Tolerances: ``REW_TOL``
and ``Q_TOL`` of tests/torch_env_helpers.py (the tensor engine
assembles the same dynamics in another order): measured 1.2e-7 in the
rewards and the positions and 4.8e-6 in the velocities at N=8, H=2. The
reward divides the ten digit spheres' sum by 10, which PyTorch on a card
does as a multiplication by the reciprocal and the kernel as a division:
one ulp, far inside REW_TOL.
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
    assert_observe_and_success_match, assert_rollout_close,
    jax_lane_rollout_fn, port_state, run_on_cpu, wrapper_run)
from torch_helpers import to_np
from ppi_tpu.envs.relocate_adroit import RelocateAdroit as JaxRelocateAdroit
from ppi_tpu_torch.envs.relocate import (
    BALL_RADIUS, GOAL_X, GOAL_Y, GOAL_Z, LIFT_Z, START_RANGE, TABLE_Z)
from ppi_tpu_torch.envs.relocate_adroit import (
    BALL_X, BALL_Y, BALL_Z, N_ACT, RelocateAdroit, RelocateAdroitState)

# H=2, not 4: at 413k eager ops a step the file would pass its 90 s
N, H = 8, 2
GOALS = {"a": (0.55, 0.15, 0.85), "b": (0.65, 0.10, 0.88)}
TABLE, SLIDE, AIR = range(3), range(3, 6), range(6, 8)


@pytest.fixture(scope="module")
def jenv():
    return JaxRelocateAdroit(engine="tensor")


@pytest.fixture(scope="module")
def jrun(jenv):
    """The JAX lane rollout, compiled once for every (N, H) call here."""
    return jax_lane_rollout_fn(jenv)


@pytest.fixture(scope="module")
def lanes(jenv):
    """(q0, qd0, actions): the ball on the table, sliding into the thumb,
    and falling beside the fingers; actions are the arm's and the digits'
    posture plus 0.3 z."""
    q = np.asarray(jenv.reset(jax.random.key(0)).physics.qpos).copy()
    q[BALL_X], q[BALL_Y] = 0.02, -0.03
    q0 = np.tile(q, (N, 1))
    qd0 = np.zeros_like(q0)
    qd0[SLIDE, BALL_Y] = -2.0
    q0[AIR, BALL_Y], q0[AIR, BALL_Z] = 0.2, 0.1
    acts = (q0[:, None, :N_ACT] + 0.3 * np.random.default_rng(0)
            .standard_normal((N, H, N_ACT))).astype(np.float32)
    return q0, qd0, acts


@pytest.fixture(scope="module")
def reference(jenv, jrun, lanes):
    """{goal: (JAX state, (rewards, qf, qdf))}."""
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, goal in GOALS.items():
        js = s0.replace(target=jnp.asarray(goal, jnp.float32))
        out[name] = (js, jrun(js, *lanes))
    return out


@pytest.fixture(scope="module")
def plain(reference, lanes):
    """{goal: the wrapper's CPU path (the plain version) on the lanes}."""
    return {name: wrapper_run(RelocateAdroit(),
                              port_state(RelocateAdroitState, js), lanes[2],
                              lanes[0], lanes[1])
            for name, (js, _) in reference.items()}


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, RelocateAdroit())


def test_reset_goal_and_start_match_reference(jenv):
    js = jenv.reset(jax.random.key(3))
    start = np.asarray(js.physics.qpos)[[BALL_X, BALL_Y]]
    s = RelocateAdroit().reset(None, "cpu", goal=np.asarray(js.target),
                               start=start)
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.physics.qvel),
                                  np.asarray(js.physics.qvel))
    assert s.physics.qpos.shape == (24,)
    np.testing.assert_array_equal(to_np(s.target), np.asarray(js.target))
    ps = port_state(RelocateAdroitState, js)
    np.testing.assert_array_equal(to_np(ps.target), np.asarray(js.target))
    a, b = (RelocateAdroit().reset(torch.Generator().manual_seed(k), "cpu")
            for k in (1, 2))
    assert not torch.allclose(a.target, b.target)
    lo = np.array([GOAL_X[0], GOAL_Y[0], GOAL_Z[0]], np.float32)
    hi = np.array([GOAL_X[1], GOAL_Y[1], GOAL_Z[1]], np.float32)
    for s in (a, b):
        assert np.all(to_np(s.target) >= lo) and np.all(to_np(s.target) <= hi)
        assert np.all(np.abs(to_np(s.physics.qpos)[[BALL_X, BALL_Y]])
                      <= START_RANGE)
    fixed = RelocateAdroit(fixed_goal=True).reset(None, "cpu")
    jfixed = JaxRelocateAdroit(engine="tensor", fixed_goal=True).reset(
        jax.random.key(0))
    np.testing.assert_array_equal(to_np(fixed.target),
                                  np.asarray(jfixed.target))
    np.testing.assert_array_equal(to_np(fixed.physics.qpos),
                                  np.asarray(jfixed.physics.qpos))
    np.testing.assert_array_equal(to_np(RelocateAdroit().action_low),
                                  np.asarray(jenv.action_low))
    np.testing.assert_array_equal(to_np(RelocateAdroit().action_high),
                                  np.asarray(jenv.action_high))


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, RelocateAdroit())


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_plain_rollout_matches_reference(reference, plain, goal):
    assert_rollout_close(plain[goal], reference[goal][1])


def test_the_thumb_stops_the_sliding_ball(reference, lanes):
    """The table's friction takes at most mu g t = 0.47 m/s from a sliding
    ball in two steps; the thumb's contact stops it. The balls on the table
    stay within 1 cm, the falling ones above the lift gate."""
    _, qf, qdf = reference["a"][1]
    assert np.all(qdf[SLIDE, BALL_Y] > -1.0)
    moved = np.abs(qf[:, [BALL_X, BALL_Y]] - lanes[0][:, [BALL_X, BALL_Y]]
                   ).max(1)
    assert np.all(moved[TABLE] < 0.01)
    assert np.all(TABLE_Z + BALL_RADIUS + qf[AIR, BALL_Z] > LIFT_Z)


def test_goals_change_the_rewards_not_the_dynamics(reference):
    """The goal enters the reward behind the lift gate: only the lanes
    whose ball is in the air are paid differently under the two goals."""
    (ra, qa, _), (rb, qb, _) = reference["a"][1], reference["b"][1]
    np.testing.assert_array_equal(qa, qb)
    np.testing.assert_array_equal(ra[:AIR.start], rb[:AIR.start])
    assert np.all(np.abs(ra.sum(1) - rb.sum(1))[AIR] > 1e-2)
    # no proximity bonus (+10/+20) in any step
    assert np.all(np.abs(ra) < 4.0) and np.all(np.abs(rb) < 4.0)


def test_kernel_step_on_cpu_is_the_eager_step(reference, lanes):
    q0, _, acts = lanes
    assert_kernel_step_is_the_eager_step(
        RelocateAdroit(), port_state(RelocateAdroitState, reference["b"][0]),
        q0[4], acts[4, 0])


def test_kernel_objective_costs_match_reference(jrun, reference, lanes):
    js = reference["b"][0]
    q = np.tile(np.asarray(js.physics.qpos), (N, 1))
    rew, _, _ = jrun(js, q, np.zeros_like(q), lanes[2])
    assert_objective_costs_match(RelocateAdroit(),
                                 port_state(RelocateAdroitState, js),
                                 lanes[2], rew)


def test_nan_lane_goes_nan_alone(reference, plain, lanes):
    q0, qd0, acts = lanes
    assert_nan_lane_goes_nan_alone(
        RelocateAdroit(), port_state(RelocateAdroitState, reference["a"][0]),
        acts, q0, qd0, clean=plain["a"][0])


def test_observe_and_success_match_reference(jenv, reference):
    js = reference["a"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    # the ball carried to within 0.1 of goal a
    qpos[BALL_X], qpos[BALL_Y], qpos[BALL_Z] = -0.03, 0.12, 0.2
    carried = js.replace(physics=js.physics.replace(qpos=jnp.asarray(qpos)))
    assert_observe_and_success_match(jenv, RelocateAdroit(),
                                     RelocateAdroitState,
                                     [(js, False), (carried, True)])


def test_host_c_build_matches_plain(reference, lanes):
    """The 24-DoF body with reward constants, as host C, over 2 steps of
    table, sliding, falling and NaN lanes."""
    q0, qd0, acts = lanes
    pick = [0, 1, 3, 6]
    bad = q0[pick].copy()
    bad[1, 0] = np.nan
    assert_host_c_matches_plain(
        RelocateAdroit(), port_state(RelocateAdroitState, reference["b"][0]),
        acts[pick, :2], bad, qd0[pick])


def test_runner_runs_relocate_adroit_on_cpu():
    run_on_cpu(["Mppi", "relocate-v0-adroit", "ColouredNoise", "--beta", "2",
                "--alpha", "10", "--anneal", "0.9"], N_ACT, horizon=H)
