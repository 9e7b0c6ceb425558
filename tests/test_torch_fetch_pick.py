"""fetch-pick: the port's env and rollout against the JAX package.

relocate-v0's model (reused from the port's ``relocate``) at 8 substeps
under the Fetch task. Three cases from one JAX compile: "reset", drawn by
the JAX reset (key 0); "contact", the ball moved 7 cm along y from its
start so that it overlaps a fingertip of the open gripper by 5 mm and is
pushed away on the table; "contact_goal", the same start with a second
goal 2 cm from the ball, inside both carry bonuses (10 cm and 5 cm). The
two bonuses and the lift gate are step functions, so the reward entries
within THRESHOLD_BAND of one are left out of the comparison and counted.
Tolerances are tests/test_torch_rollout.py's (tests/torch_env_helpers.py).
"""

import jax
import numpy as np
import pytest

from torch_env_helpers import (
    assert_host_c_matches_plain, assert_kernel_step_is_the_eager_step,
    assert_model_equals_reference, assert_nan_lane_goes_nan_alone,
    assert_objective_costs_match, assert_observe_and_success_match,
    assert_rollout_close_off_thresholds, assert_uniform, jax_rollout_fn,
    pinned_jax_state, port_state, resets, run_on_cpu, step_coordinates,
    wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.fetch_pick import FetchPickAndPlace as JaxFetchPick
from ppi_tpu_torch.envs.fetch_pick import (
    ARM_POSE, GOAL_AIR_Z, SUCCESS_RADIUS, FetchPickAndPlace, FetchPickState)
from ppi_tpu_torch.envs.relocate import (
    BALL_RADIUS, BALL_START, BALL_X, BALL_Y, LIFT_Z, TABLE_Z)

N, H = 8, 3
CONTACT_Q = (*ARM_POSE, 0.0, 0.07, 0.0)
BALL_AT_CONTACT = (BALL_START[0], BALL_START[1] + 0.07,
                   TABLE_Z + BALL_RADIUS)
SECOND_GOAL = (BALL_AT_CONTACT[0] + 0.02, *BALL_AT_CONTACT[1:])


@pytest.fixture(scope="module")
def acts():
    """PD targets about the arm's pose; scale 0.4 reaches past the
    fingers' limits in some cells."""
    return (np.array(ARM_POSE, np.float32) + 0.4 * np.random.default_rng(
        0).standard_normal((N, H, 6))).astype(np.float32)


@pytest.fixture(scope="module")
def reference(acts):
    """{case: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    jenv = JaxFetchPick()
    run = jax_rollout_fn(jenv)
    js = jenv.reset(jax.random.key(0))
    contact = pinned_jax_state(js, qpos=CONTACT_Q)
    cases = {"reset": js, "contact": contact,
             "contact_goal": pinned_jax_state(contact, target=SECOND_GOAL)}
    return {k: (s, run(s, acts)) for k, s in cases.items()}


def _state(reference, name):
    return port_state(FetchPickState, reference[name][0])


@pytest.fixture(scope="module")
def plain(reference, acts):
    """{case: the port's plain rollout (rewards, qf, qdf)}."""
    return {c: wrapper_run(FetchPickAndPlace(), _state(reference, c), acts)
            for c in reference}


@pytest.fixture(scope="module")
def margins(reference, acts):
    """{case: (threshold margin, carry)}."""
    return {c: _threshold_margin(FetchPickAndPlace(), _state(reference, c),
                                 acts) for c in reference}


def _threshold_margin(env, state, acts):
    """The distance of the ball's carry to the 10 cm and 5 cm bonus radii
    and of its height to the lift gate, whichever is least, after each
    step; and the carry."""
    q, _ = step_coordinates(env, state, acts)
    _, _, ball = env._sites(to_torch(q))
    ball = to_np(ball)
    carry = np.linalg.norm(ball - to_np(state.target), axis=-1)
    margin = np.minimum(
        np.minimum(np.abs(carry - 2 * SUCCESS_RADIUS),
                   np.abs(carry - SUCCESS_RADIUS)),
        np.abs(ball[..., 2] - LIFT_Z))
    return margin, carry


def test_model_matches_reference():
    assert_model_equals_reference(JaxFetchPick(), FetchPickAndPlace())


def test_reset_distribution():
    """The ball start U(-0.05, 0.05)^2; the goal's xy the start plus
    U(-0.12, 0.12)^2; its height on the table or, with probability 0.5, in
    the air band."""
    states = resets(FetchPickAndPlace())
    start = np.stack([to_np(s.physics.qpos[BALL_X:BALL_Y + 1])
                      for s in states])
    assert_uniform(start, -0.05, 0.05)
    goals = np.stack([to_np(s.target) for s in states])
    assert_uniform(goals[:, :2] - (np.array(BALL_START) + start), -0.12,
                   0.12)
    on_table = np.isclose(goals[:, 2], TABLE_Z + BALL_RADIUS)
    air = goals[~on_table, 2] - TABLE_Z
    assert_uniform(air[:, None], *GOAL_AIR_Z)
    n = len(goals)
    assert abs(on_table.mean() - 0.5) < 4.5 * 0.5 / np.sqrt(n)
    fixed = FetchPickAndPlace(fixed_goal=True).reset(None, "cpu")
    jfixed = JaxFetchPick(fixed_goal=True).reset(jax.random.key(0))
    np.testing.assert_allclose(to_np(fixed.target),
                               np.asarray(jfixed.target), rtol=1e-7)
    np.testing.assert_array_equal(to_np(fixed.physics.qpos),
                                  np.asarray(jfixed.physics.qpos))


@pytest.mark.parametrize("case", ["reset", "contact", "contact_goal"])
def test_plain_rollout_matches_reference(reference, plain, margins, case):
    masked = assert_rollout_close_off_thresholds(
        plain[case], reference[case][1], margins[case][0])
    assert masked <= 2, f"{masked} reward entries at a threshold"


def test_the_fingertip_moves_the_ball_into_the_bonuses(reference, margins):
    """From the contact start the ball moves in every lane; at the second
    goal both carry bonuses are paid."""
    q0 = np.asarray(reference["contact"][0].physics.qpos)
    qf = reference["contact"][1][1]
    assert np.all(np.abs(qf[:, BALL_X:] - q0[BALL_X:]).max(1) > 1e-3)
    assert np.all(margins["contact_goal"][1] < SUCCESS_RADIUS)
    rew = reference["contact_goal"][1][0]
    assert np.all(rew > reference["contact"][1][0] + 25.0)


def test_step_is_the_kernel_step(reference, acts):
    s = _state(reference, "contact")
    assert_kernel_step_is_the_eager_step(FetchPickAndPlace(), s,
                                         to_np(s.physics.qpos), acts[0, 0])


def test_actions_past_the_box_are_clipped(reference, plain, acts):
    env, s = FetchPickAndPlace(), _state(reference, "contact")
    lo, hi = to_np(env.action_low), to_np(env.action_high)
    assert np.mean((acts < lo) | (acts > hi)) > 0.02
    for a, b in zip(plain["contact"],
                    wrapper_run(env, s, np.clip(acts, lo, hi))):
        np.testing.assert_array_equal(a, b)


def test_kernel_objective_costs_match_reference(reference, acts):
    assert_objective_costs_match(
        FetchPickAndPlace(), _state(reference, "contact_goal"), acts,
        reference["contact_goal"][1][0])


def test_goals_change_the_costs(plain):
    costs = [-plain[c][0].sum(1) for c in ("contact", "contact_goal")]
    assert np.all(np.abs(costs[0] - costs[1]) > 1e-3)


def test_nan_lane_goes_nan_alone(reference, plain, acts):
    assert_nan_lane_goes_nan_alone(FetchPickAndPlace(),
                                   _state(reference, "contact"), acts,
                                   clean=plain["contact"][0])


def test_host_c_build_matches_plain(reference, acts):
    """The 8-substep body with the three constants as host C, a NaN lane
    included."""
    s = _state(reference, "contact_goal")
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[6, BALL_Y] = np.nan
    qd0 = np.zeros_like(q0)
    assert_host_c_matches_plain(FetchPickAndPlace(), s, acts, q0, qd0)


def test_observe_and_success_match_reference(reference):
    assert_observe_and_success_match(
        JaxFetchPick(), FetchPickAndPlace(), FetchPickState,
        [(reference["reset"][0], False), (reference["contact"][0], False),
         (reference["contact_goal"][0], True)])


def test_runner_runs_fetch_pick_on_cpu():
    run_on_cpu(["Mppi", "fetch-pick", "ColouredNoise", "--beta", "2",
                "--alpha", "10", "--anneal", "0.9"], 6)
