"""fetch-push: the port's env and rollout against the JAX package.

Three cases from one JAX compile: "reset", drawn by the JAX reset (key 0);
"contact", the box moved under the paddle so that the two spheres overlap
by 8 mm and the box is pushed along its friction-held slides from the
first substep; and "contact_goal", the same start with a second goal 3 cm
from the box, inside the 5 cm bonus radius. The bonus is a step function of
the box-to-goal distance, so the reward entries within THRESHOLD_BAND of
its radius are left out of the comparison and counted (none in these
cases). Tolerances are tests/test_torch_rollout.py's
(tests/torch_env_helpers.py).
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
from ppi_tpu.envs.push import FetchPush as JaxFetchPush
from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_mpc_objective
from ppi_tpu_torch.envs.push import (
    BOX_START, BOX_X, BOX_Y, FetchPush, PushState)

N, H = 8, 6
ARM = np.array([0.0, 0.7, -0.9, 0.3], np.float32)
CONTACT_Q = (*ARM, 0.15, -0.1)   # box centre 0.097 from the paddle's
BOX_AT_CONTACT = (BOX_START[0] + 0.15, BOX_START[1] - 0.1)
SECOND_GOAL = (BOX_AT_CONTACT[0] - 0.03, BOX_AT_CONTACT[1])


@pytest.fixture(scope="module")
def acts():
    """PD targets about the arm's pose; scale 1.2 reaches past the box's
    +-1.2 shoulder limit in some cells."""
    return (ARM + 1.2 * np.random.default_rng(0).standard_normal(
        (N, H, 4))).astype(np.float32)


@pytest.fixture(scope="module")
def reference(acts):
    """{case: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    jenv = JaxFetchPush()
    run = jax_rollout_fn(jenv)
    js = jenv.reset(jax.random.key(0))
    contact = pinned_jax_state(js, qpos=CONTACT_Q)
    cases = {"reset": js, "contact": contact,
             "contact_goal": pinned_jax_state(contact, target=SECOND_GOAL)}
    return {k: (s, run(s, acts)) for k, s in cases.items()}


def _state(reference, name):
    return port_state(PushState, reference[name][0])


def _bonus_margin(env, state, acts):
    """|box-to-goal distance - bonus radius| after each step."""
    q, _ = step_coordinates(env, state, acts)
    box = np.stack([BOX_START[0] + q[..., BOX_X], BOX_START[1] + q[..., BOX_Y]],
                   -1)
    d = np.linalg.norm(box - to_np(state.target), axis=-1)
    return np.abs(d - env.success_radius), d


def test_model_matches_reference():
    assert_model_equals_reference(JaxFetchPush(), FetchPush())


def test_reset_distribution():
    """The box start U(-0.05, 0.05)^2 about BOX_START; the goal the start
    plus an offset in U(-0.15, 0.15)^2 at least 0.1 m long."""
    states = resets(FetchPush())
    start = np.stack([to_np(s.physics.qpos[BOX_X:]) for s in states])
    assert_uniform(start, -0.05, 0.05)
    off = np.stack([to_np(s.target) for s in states]) \
        - (np.array(BOX_START, np.float32) + start)
    assert np.all(np.abs(off) <= 0.15 + 1e-6)
    assert np.all(np.linalg.norm(off, axis=1) >= 0.1 - 1e-6)
    assert np.all(np.abs(off.mean(0)) < 4.5 * 0.3 / np.sqrt(12 * len(off)))
    for s in states[:3]:
        np.testing.assert_array_equal(to_np(s.physics.qpos[:4]), ARM)
    fixed = FetchPush(fixed_goal=True).reset(None, "cpu")
    jfixed = JaxFetchPush(fixed_goal=True).reset(jax.random.key(0))
    np.testing.assert_array_equal(to_np(fixed.target),
                                  np.asarray(jfixed.target))
    np.testing.assert_array_equal(to_np(fixed.physics.qpos),
                                  np.asarray(jfixed.physics.qpos))


@pytest.mark.parametrize("case", ["reset", "contact", "contact_goal"])
def test_plain_rollout_matches_reference(reference, acts, case):
    env, s = FetchPush(), _state(reference, case)
    margin, _ = _bonus_margin(env, s, acts)
    masked = assert_rollout_close_off_thresholds(wrapper_run(env, s, acts),
                                                 reference[case][1], margin)
    assert masked <= 2, f"{masked} reward entries at the bonus radius"


def test_the_paddle_pushes_the_box_into_the_bonus(reference, acts):
    """From the contact start the box moves in every lane; at the second
    goal the +5 bonus is paid in some entries and not in others."""
    q0 = np.asarray(reference["contact"][0].physics.qpos)
    qf = reference["contact"][1][1]
    assert np.all(np.abs(qf[:, BOX_X:] - q0[BOX_X:]).max(1) > 1e-3)
    env, s = FetchPush(), _state(reference, "contact_goal")
    _, d = _bonus_margin(env, s, acts)
    inside = d < env.success_radius
    assert inside.any() and not inside.all()
    rew = reference["contact_goal"][1][0]
    rew_far = reference["contact"][1][0]
    assert np.all(rew[inside] > rew_far[inside] + 4.0)


def test_step_is_the_kernel_step(reference, acts):
    s = _state(reference, "contact")
    assert_kernel_step_is_the_eager_step(FetchPush(), s,
                                         to_np(s.physics.qpos), acts[0, 0])


def test_actions_past_the_box_are_clipped(reference, acts):
    """The PD targets are clipped to the arm's box: clipping them first
    changes nothing."""
    env, s = FetchPush(), _state(reference, "contact")
    lo, hi = to_np(env.action_low), to_np(env.action_high)
    assert np.mean((acts < lo) | (acts > hi)) > 0.05
    got = wrapper_run(env, s, acts)
    for a, b in zip(got, wrapper_run(env, s, np.clip(acts, lo, hi))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["reset", "contact_goal"])
def test_kernel_objective_costs_match_reference(reference, acts, case):
    assert_objective_costs_match(FetchPush(), _state(reference, case), acts,
                                 reference[case][1][0])


def test_goals_change_the_costs(reference, acts):
    costs = [to_np(kernel_mpc_objective(
        FetchPush(), _state(reference, c), H)(None, to_torch(acts)))
        for c in ("contact", "contact_goal")]
    assert np.all(np.abs(costs[0] - costs[1]) > 1e-3)


def test_nan_lane_goes_nan_alone(reference, acts):
    assert_nan_lane_goes_nan_alone(FetchPush(),
                                   _state(reference, "contact"), acts)


def test_host_c_build_matches_plain(reference, acts):
    """The friction-held slides, the contact and the bonus comparison as
    host C, a NaN lane included."""
    s = _state(reference, "contact_goal")
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[2, BOX_Y] = np.nan
    qd0 = np.zeros_like(q0)
    assert_host_c_matches_plain(FetchPush(), s, acts, q0, qd0)


def test_routed_split_build_matches_reference(reference, acts):
    """fetch-push routes to the split layout with its arm's chain cut into
    segments: that body built as host C against ``ppi_tpu``'s rollout on
    the same numpy inputs, from each case, within the rollout tolerances
    (the bonus radius's entries left out, as for the plain path)."""
    from test_torch_warp_layout import _host_run, _needs_cc
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    _needs_cc()
    env = FetchPush()
    assert (rk.kernel_layout(env), rk.split_partition(env)) == (
        "split", "chain")
    header = rk.generate_split(*rk.body_args(env, _state(reference, "reset")),
                               partition=rk.split_partition(env))[0]
    run = rk.load_host_split_rollout(header)
    for case in ("reset", "contact", "contact_goal"):
        s = _state(reference, case)
        q0 = np.tile(to_np(s.physics.qpos), (N, 1))
        qd0 = np.tile(to_np(s.physics.qvel), (N, 1))
        margin, _ = _bonus_margin(env, s, acts)
        masked = assert_rollout_close_off_thresholds(
            _host_run(run, env, s, q0, qd0, acts), reference[case][1],
            margin)
        assert masked <= 2, f"{case}: {masked} entries at the bonus radius"


def test_observe_and_success_match_reference(reference):
    js = reference["contact_goal"][0]
    q = np.asarray(js.physics.qpos).copy()
    q[BOX_X] -= 0.02   # the box 1 cm from the goal
    assert_observe_and_success_match(
        JaxFetchPush(), FetchPush(), PushState,
        [(reference["reset"][0], False), (js, True),
         (pinned_jax_state(js, qpos=q), True),
         (reference["contact"][0], False)])


def test_runner_runs_fetch_push_on_cpu():
    run_on_cpu(["Mppi", "fetch-push", "ColouredNoise", "--beta", "2",
                "--alpha", "10", "--anneal", "0.9"], 4)
