"""door-v0-adroit: the port's env and rollout against the JAX package.

The JAX reference is ``DoorAdroit(engine="tensor")``, the JAX package's
CPU test engine (its default, "stacked", is XLA's assembly of the same
dynamics; the port runs the scalar program, whose CPU compile in JAX is
infeasible at 23 DoF). The lanes are door-v0-hand's
(``torch_env_helpers.hand_door_lanes``): from the reset posture, and with
the door opening from 0.02 rad with the latch up (the bolt clamp fires) or
pressed (it does not). Tolerances are tests/test_torch_rollout.py's
(tests/torch_env_helpers.py): measured 1.1e-7 in the rewards and 3e-6 in
the velocities at N=8, H=4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    REW_TOL, assert_hand_projection_matches, assert_hand_torque_matches,
    assert_host_c_matches_plain, assert_model_equals_reference,
    assert_rollout_close, hand_door_lanes, jax_lane_rollout_fn, port_state,
    wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.door_adroit import DoorAdroit as JaxDoorAdroit
from ppi_tpu_torch.envs.door_adroit import (
    DOOR, LATCH, N_ACT, DoorAdroit, DoorAdroitState)
from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_mpc_objective
from ppi_tpu_torch.runners import run_mpc

N, H = 8, 4


@pytest.fixture(scope="module")
def jenv():
    return JaxDoorAdroit(engine="tensor")


@pytest.fixture(scope="module")
def lanes(jenv):
    """(JAX state, q0, qd0, actions, clamped lanes, free lanes)."""
    return hand_door_lanes(jenv, DoorAdroit(), N, H)


@pytest.fixture(scope="module")
def reference(jenv, lanes):
    js, q0, qd0, acts, _, _ = lanes
    return jax_lane_rollout_fn(jenv)(js, q0, qd0, acts)


@pytest.fixture(scope="module")
def plain(lanes):
    """The wrapper's CPU path (the plain version) on the lanes."""
    js, q0, qd0, acts, _, _ = lanes
    return wrapper_run(DoorAdroit(), port_state(DoorAdroitState, js), acts,
                       q0, qd0)


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, DoorAdroit())


def test_reset_and_frame_match_reference(jenv, lanes):
    js = lanes[0]
    s = DoorAdroit().reset(None, "cpu", frame=np.asarray(js.frame))
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.frame), np.asarray(js.frame))
    assert s.physics.qpos.shape == (23,)
    sampled = DoorAdroit().reset(torch.Generator().manual_seed(1), "cpu")
    assert not torch.equal(sampled.frame, s.frame)
    fixed = DoorAdroit(fixed_scene=True).reset(None, "cpu")
    np.testing.assert_array_equal(
        to_np(fixed.frame),
        np.asarray(JaxDoorAdroit(engine="tensor", fixed_scene=True).reset(
            None).frame))


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, DoorAdroit())


@pytest.mark.parametrize("case", ["bolted", "unlatched", "ajar"])
def test_projection_matches_reference(jenv, case):
    assert_hand_projection_matches(jenv, DoorAdroit(), case)


def test_plain_rollout_matches_reference(plain, reference):
    assert_rollout_close(plain, reference)


def test_clamp_fires_in_bolted_lanes_only(lanes, plain, reference):
    _, _, _, _, clamped, free = lanes
    env = DoorAdroit()
    _, qf, qdf = plain
    np.testing.assert_array_equal(qf[clamped, DOOR],
                                  np.float32(env.bolt_depth))
    assert np.all(qdf[clamped, DOOR] <= 0.0)
    assert np.all(qf[free, DOOR] > env.bolt_depth + 0.02)
    np.testing.assert_array_equal(reference[1][clamped, DOOR],
                                  np.float32(env.bolt_depth))


def test_kernel_objective_costs_match_reference(jenv, lanes):
    """From the reset state, over H=2 with the second step masked."""
    js, _, _, acts, _, _ = lanes
    acts = acts[:, :2]
    rew, _, _ = jax_lane_rollout_fn(jenv)(
        js, np.tile(np.asarray(js.physics.qpos), (N, 1)),
        np.zeros((N, 23), np.float32), acts)
    mask = np.array([1.0, 0.0], np.float32)
    masked = kernel_mpc_objective(
        DoorAdroit(), port_state(DoorAdroitState, js), 2, to_torch(mask))(
            None, to_torch(acts))
    np.testing.assert_allclose(to_np(masked), -(rew * mask).sum(1), **REW_TOL)


def test_nan_lane_goes_nan_alone(lanes, plain):
    js, q0, qd0, acts, _, _ = lanes
    bad = qd0.copy()
    bad[5, LATCH] = np.inf
    rew, _, _ = wrapper_run(DoorAdroit(), port_state(DoorAdroitState, js),
                            acts, q0, bad)
    assert np.isnan(rew[5]).all()
    keep = np.arange(N) != 5
    np.testing.assert_array_equal(rew[keep], plain[0][keep])


def test_observe_and_success_match_reference(jenv, lanes):
    js = lanes[0]
    env = DoorAdroit()
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[DOOR] = 1.4   # swung open past the success angle
    for q, want in ((np.asarray(js.physics.qpos), False), (qpos, True)):
        jst = js.replace(physics=js.physics.replace(qpos=jnp.asarray(q)))
        st = port_state(DoorAdroitState, jst)
        np.testing.assert_allclose(to_np(env.observe(st)),
                                   np.asarray(jenv.observe(jst)), rtol=1e-5,
                                   atol=1e-6)
        assert bool(env.success(st)) == bool(jenv.success(jst)) == want


def test_host_c_build_matches_plain(lanes):
    """The 23-DoF body with the projection, as host C, over 2 steps of a
    clamped, a free, a reset and a NaN lane."""
    js, q0, qd0, acts, _, _ = lanes
    pick = [0, 1, 4, 7]
    q, qd = q0[pick].copy(), qd0[pick]
    q[1, 3] = np.nan
    assert_host_c_matches_plain(DoorAdroit(), port_state(DoorAdroitState, js),
                                acts[pick, :2], q, qd)


def test_runner_runs_door_adroit_on_cpu():
    args = run_mpc.build_parser().parse_args([
        "Lbps", "door-v0-adroit", "SquaredExponentialKernel", "--delta",
        "0.9", "--n-iters", "1", "--anneal", "0.5", "--lengthscale", "0.08",
        "--horizon", "2", "--timesteps", "1", "--n-warmstart-iters", "1",
        "--device", "cpu", "MonteCarlo", "--n-samples", "4"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success is False
    assert track["action"].shape == (1, N_ACT)
    assert bool(torch.isfinite(track["obs"]).all())
