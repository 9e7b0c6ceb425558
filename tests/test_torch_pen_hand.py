"""pen-v0-hand: the port's env and rollout against the JAX package.

The JAX reference is ``PenHand(engine="tensor")``, the JAX package's CPU
test engine (its scalar program takes tens of minutes to compile on the
CPU at 11 DoF). The first half of the lanes starts from the reset posture;
in the second half the pen starts 2 cm low, on the two fingers, whose
contacts then turn it (yaw and pitch have no spring: only contact moves
them). The goal axes are pen-v0's pinned ones, with a similarity below 0.6
to the reset axis, so the aligned bonuses cannot switch within H=4.
Tolerances: rewards 1e-6, positions 1e-6, velocities 1e-5, absolute and
relative (the tensor engine assembles the same dynamics in another order):
measured 1.8e-7, 2.0e-7 and 1.1e-5 (on a velocity of 1.3) at N=8, H=4.
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
from ppi_tpu.envs.pen import axis_from_angles as jax_axis_from_angles
from ppi_tpu.envs.pen_hand import PenHand as JaxPenHand
from ppi_tpu_torch.envs.pen_hand import (
    A_MCP, N_ACT, PEN_PITCH, PEN_YAW, PEN_Z, PenHand, PenHandState)

N, H = 8, 4
GOALS = {"a": (0.9, -0.6), "b": (-0.95, 0.5)}  # (yaw, pitch) in U(-1, 1)
TOL = dict(rtol=1e-6, atol=1e-6)
VEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_allclose(got[1], ref[1], **TOL)
    np.testing.assert_allclose(got[2], ref[2], **VEL_TOL)


@pytest.fixture(scope="module")
def jenv():
    return JaxPenHand(engine="tensor")


@pytest.fixture(scope="module")
def lanes(jenv):
    """(q0, qd0, actions): reset lanes, then lanes with the pen on the
    fingers."""
    q = np.asarray(jenv.reset(jax.random.key(0)).physics.qpos)
    q0 = np.tile(q, (N, 1))
    q0[N // 2:, PEN_Z] = -0.02
    acts = (q0[:, None, A_MCP:] + 0.5 * np.random.default_rng(0)
            .standard_normal((N, H, N_ACT))).astype(np.float32)
    return q0, np.zeros_like(q0), acts


@pytest.fixture(scope="module")
def reference(jenv, lanes):
    """{goal: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    run = jax_lane_rollout_fn(jenv)
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, (yaw, pitch) in GOALS.items():
        js = s0.replace(target_axis=jax_axis_from_angles(yaw, pitch))
        out[name] = (js, run(js, *lanes))
    return out


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, PenHand())


def test_reset_and_goal_match_reference(jenv):
    js = jenv.reset(jax.random.key(3))
    s = PenHand().reset(None, "cpu", goal=np.asarray(js.target_axis))
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.target_axis),
                                  np.asarray(js.target_axis))
    ps = port_state(PenHandState, js)
    np.testing.assert_array_equal(to_np(ps.target_axis),
                                  np.asarray(js.target_axis))
    sampled = [PenHand().reset(torch.Generator().manual_seed(k), "cpu")
               for k in (1, 2)]
    assert not torch.allclose(sampled[0].target_axis, sampled[1].target_axis)
    assert abs(float(torch.linalg.norm(sampled[0].target_axis)) - 1.0) < 1e-6
    fixed = PenHand(fixed_goal=True).reset(None, "cpu")
    np.testing.assert_allclose(to_np(fixed.target_axis), np.asarray(
        JaxPenHand(engine="tensor", fixed_goal=True).reset(
            jax.random.key(0)).target_axis), rtol=1e-6, atol=1e-7)


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, PenHand())


@pytest.mark.parametrize("goal", sorted(GOALS))
def test_plain_rollout_matches_reference(reference, lanes, goal):
    js, ref = reference[goal]
    q0, qd0, acts = lanes
    _close(wrapper_run(PenHand(), port_state(PenHandState, js), acts, q0,
                       qd0), ref)


def test_contacts_turn_the_pen(reference):
    """Only the lanes whose pen lies on the fingers turn it."""
    _, qf, _ = reference["a"][1]
    turned = np.abs(qf[:, [PEN_YAW, PEN_PITCH]]).max(1)
    assert np.all(turned[N // 2:] > 0.05) and np.all(turned[:N // 2] < 0.05)


def test_goals_change_the_rewards_not_the_dynamics(reference):
    (ra, qa, _), (rb, qb, _) = reference["a"][1], reference["b"][1]
    np.testing.assert_array_equal(qa, qb)
    assert np.all(np.abs(ra.sum(1) - rb.sum(1))[N // 2:] > 1e-2)
    # no aligned bonus (+10/+50) and no drop (-5) in any step
    assert np.all(np.abs(ra) < 4.0) and np.all(np.abs(rb) < 4.0)


def test_step_over_lanes_matches_reference(reference, lanes):
    js, ref = reference["a"]
    assert_step_rollout_matches(PenHand(), port_state(PenHandState, js),
                                *lanes, ref)


def test_kernel_step_on_cpu_is_the_eager_step(reference, lanes):
    q0, _, acts = lanes
    assert_kernel_step_is_the_eager_step(
        PenHand(), port_state(PenHandState, reference["b"][0]), q0[5],
        acts[5, 0])


def test_kernel_objective_costs_match_reference(jenv, reference, lanes):
    js = reference["b"][0]
    q = np.tile(np.asarray(js.physics.qpos), (N, 1))
    rew, _, _ = jax_lane_rollout_fn(jenv)(js, q, np.zeros_like(q), lanes[2])
    assert_objective_costs_match(PenHand(), port_state(PenHandState, js),
                                 lanes[2], rew)


def test_nan_lane_goes_nan_alone(reference, lanes):
    q0, qd0, acts = lanes
    assert_nan_lane_goes_nan_alone(
        PenHand(), port_state(PenHandState, reference["a"][0]), acts, q0, qd0)


def test_observe_and_success_match_reference(jenv, reference):
    js = reference["a"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[PEN_YAW], qpos[PEN_PITCH] = GOALS["a"]   # the pen turned onto goal a
    turned = js.replace(physics=js.physics.replace(qpos=jnp.asarray(qpos)))
    assert_observe_and_success_match(jenv, PenHand(), PenHandState,
                                     [(js, False), (turned, True)])


def test_host_c_build_matches_plain(reference, lanes):
    """The 11-DoF body with reward constants, as host C, on free, contact
    and NaN lanes."""
    q0, qd0, acts = lanes
    bad = q0.copy()
    bad[1, 0] = np.nan
    assert_host_c_matches_plain(
        PenHand(), port_state(PenHandState, reference["b"][0]), acts[:, :3],
        bad, qd0)


def test_runner_runs_pen_hand_on_cpu():
    run_on_cpu(["Lbps", "pen-v0-hand", "SquaredExponentialKernel", "--delta",
                "0.9", "--n-iters", "2", "--anneal", "0.5", "--lengthscale",
                "0.08"], N_ACT)
