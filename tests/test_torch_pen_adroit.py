"""pen-v0-adroit: the port's env and rollout against the JAX package.

The JAX reference is ``PenAdroit(engine="tensor")``, the JAX package's CPU
test engine (its default, "stacked", is XLA's assembly of the same
dynamics; the port runs the scalar program, whose CPU compile in JAX is
infeasible at 20 DoF), jitted once for the file. The first half of the
lanes starts from the reset posture, the digits clear of the rod; in the
second half the pen starts 2 cm low, on the four fingers' proximal
spheres, whose contacts then turn it (yaw and pitch have no spring: only
contact moves them). The goal axes are pen-v0's pinned ones, with a
similarity below 0.6 to the reset axis, so the aligned bonuses cannot
switch within H=4. Tolerances: ``REW_TOL`` and ``Q_TOL`` of
tests/torch_env_helpers.py (the tensor engine assembles the same dynamics
in another order): measured 1.2e-7 in the rewards, 7e-8 in the positions
and 1.3e-6 in the velocities at N=8, H=4.
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
    assert_step_rollout_matches, jax_lane_rollout_fn, port_state,
    run_on_cpu, wrapper_run)
from torch_helpers import to_np
from ppi_tpu.envs.pen import axis_from_angles as jax_axis_from_angles
from ppi_tpu.envs.pen_adroit import PenAdroit as JaxPenAdroit
from ppi_tpu_torch.envs.pen_adroit import (
    FF_ABD, N_ACT, PEN_PITCH, PEN_YAW, PEN_Z, PenAdroit, PenAdroitState)

N, H = 8, 4
GOALS = {"a": (0.9, -0.6), "b": (-0.95, 0.5)}  # (yaw, pitch) in U(-1, 1)


@pytest.fixture(scope="module")
def jenv():
    return JaxPenAdroit(engine="tensor")


@pytest.fixture(scope="module")
def jrun(jenv):
    """The JAX lane rollout, compiled once for every (N, H) call here."""
    return jax_lane_rollout_fn(jenv)


@pytest.fixture(scope="module")
def lanes(jenv):
    """(q0, qd0, actions): reset lanes, then lanes with the pen on the
    fingers; actions are the digits' posture plus 0.5 z."""
    q = np.asarray(jenv.reset(jax.random.key(0)).physics.qpos)
    q0 = np.tile(q, (N, 1))
    q0[N // 2:, PEN_Z] = -0.02
    acts = (q0[:, None, FF_ABD:] + 0.5 * np.random.default_rng(0)
            .standard_normal((N, H, N_ACT))).astype(np.float32)
    return q0, np.zeros_like(q0), acts


@pytest.fixture(scope="module")
def reference(jenv, jrun, lanes):
    """{goal: (JAX state, (rewards, qf, qdf))}."""
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, (yaw, pitch) in GOALS.items():
        js = s0.replace(target_axis=jax_axis_from_angles(yaw, pitch))
        out[name] = (js, jrun(js, *lanes))
    return out


@pytest.fixture(scope="module")
def plain(reference, lanes):
    """{goal: the wrapper's CPU path (the plain version) on the lanes}."""
    return {name: wrapper_run(PenAdroit(), port_state(PenAdroitState, js),
                              lanes[2], lanes[0], lanes[1])
            for name, (js, _) in reference.items()}


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, PenAdroit())


def test_reset_and_goal_match_reference(jenv):
    js = jenv.reset(jax.random.key(3))
    s = PenAdroit().reset(None, "cpu", goal=np.asarray(js.target_axis))
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.physics.qvel),
                                  np.asarray(js.physics.qvel))
    assert s.physics.qpos.shape == (20,)
    ps = port_state(PenAdroitState, js)
    np.testing.assert_array_equal(to_np(ps.target_axis),
                                  np.asarray(js.target_axis))
    sampled = [PenAdroit().reset(torch.Generator().manual_seed(k), "cpu")
               for k in (1, 2)]
    assert not torch.allclose(sampled[0].target_axis, sampled[1].target_axis)
    assert abs(float(torch.linalg.norm(sampled[0].target_axis)) - 1.0) < 1e-6
    fixed = PenAdroit(fixed_goal=True).reset(None, "cpu")
    np.testing.assert_allclose(to_np(fixed.target_axis), np.asarray(
        JaxPenAdroit(engine="tensor", fixed_goal=True).reset(
            jax.random.key(0)).target_axis), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(to_np(PenAdroit().action_low),
                                  np.asarray(jenv.action_low))
    np.testing.assert_array_equal(to_np(PenAdroit().action_high),
                                  np.asarray(jenv.action_high))


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, PenAdroit())


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_plain_rollout_matches_reference(reference, plain, goal):
    assert_rollout_close(plain[goal], reference[goal][1])


def test_contacts_turn_the_pen(reference):
    """Only the lanes whose pen lies on the fingers turn it."""
    _, qf, _ = reference["a"][1]
    turned = np.abs(qf[:, [PEN_YAW, PEN_PITCH]]).max(1)
    assert np.all(turned[N // 2:] > 0.02) and np.all(turned[:N // 2] < 0.02)


def test_goals_change_the_rewards_not_the_dynamics(reference):
    (ra, qa, _), (rb, qb, _) = reference["a"][1], reference["b"][1]
    np.testing.assert_array_equal(qa, qb)
    assert np.all(np.abs(ra.sum(1) - rb.sum(1)) > 1e-2)
    # no aligned bonus (+10/+50) and no drop (-5) in any step
    assert np.all(np.abs(ra) < 4.0) and np.all(np.abs(rb) < 4.0)


def test_step_over_lanes_matches_reference(reference, lanes):
    js, ref = reference["a"]
    assert_step_rollout_matches(PenAdroit(), port_state(PenAdroitState, js),
                                *lanes, ref)


def test_kernel_step_on_cpu_is_the_eager_step(reference, lanes):
    q0, _, acts = lanes
    assert_kernel_step_is_the_eager_step(
        PenAdroit(), port_state(PenAdroitState, reference["b"][0]), q0[5],
        acts[5, 0])


def test_kernel_objective_costs_match_reference(jrun, reference, lanes):
    js = reference["b"][0]
    q = np.tile(np.asarray(js.physics.qpos), (N, 1))
    rew, _, _ = jrun(js, q, np.zeros_like(q), lanes[2])
    assert_objective_costs_match(PenAdroit(), port_state(PenAdroitState, js),
                                 lanes[2], rew)


def test_nan_lane_goes_nan_alone(reference, plain, lanes):
    q0, qd0, acts = lanes
    assert_nan_lane_goes_nan_alone(
        PenAdroit(), port_state(PenAdroitState, reference["a"][0]), acts,
        q0, qd0, clean=plain["a"][0])


def test_observe_and_success_match_reference(jenv, reference):
    js = reference["a"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[PEN_YAW], qpos[PEN_PITCH] = GOALS["a"]   # the pen turned onto goal a
    turned = js.replace(physics=js.physics.replace(qpos=jnp.asarray(qpos)))
    assert_observe_and_success_match(jenv, PenAdroit(), PenAdroitState,
                                     [(js, False), (turned, True)])


def test_host_c_build_matches_plain(reference, lanes):
    """The 20-DoF body with reward constants, as host C, over 2 steps of
    free, contact and NaN lanes."""
    q0, qd0, acts = lanes
    pick = [0, 1, 5, 6]
    bad = q0[pick].copy()
    bad[1, 0] = np.nan
    assert_host_c_matches_plain(
        PenAdroit(), port_state(PenAdroitState, reference["b"][0]),
        acts[pick, :2], bad, qd0[pick])


def test_runner_runs_pen_adroit_on_cpu():
    run_on_cpu(["Lbps", "pen-v0-adroit", "SquaredExponentialKernel",
                "--delta", "0.9", "--n-iters", "1", "--anneal", "0.5",
                "--lengthscale", "0.08"], N_ACT)
