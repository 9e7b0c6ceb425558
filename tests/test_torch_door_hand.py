"""door-v0-hand: the port's env and rollout against the JAX package.

The JAX reference is ``DoorHand(engine="tensor")``, the JAX package's CPU
test engine (its scalar program takes tens of minutes to compile on the
CPU at 12 DoF). The rollout lanes (``torch_env_helpers.hand_door_lanes``)
start from the reset posture, or with the door at 0.02 rad opening at
1 rad/s: with the latch up the bolt clamp fires and holds the door at the
bolt depth; with the latch pressed past the unlock angle it does not.
Tolerances are tests/test_torch_rollout.py's (tests/torch_env_helpers.py):
measured 9e-8 in the rewards and 4e-6 in the velocities at N=8, H=4.
The T=3 MPC comparison holds the actions to 5e-4, as tests/test_torch_pen.py
does (LBPS temperature near-ties, ROADMAP queue 3), and the observation to
1e-3 absolute plus 1e-3 relative (measured 1.04e-3 on an arm velocity of
1.82 rad/s).
"""

import jax
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
import ppi_tpu.policies.primitives as jax_primitives
import ppi_tpu_torch.policies.primitives as primitives
from ppi_tpu.algorithms import make_solver as jax_make_solver
from ppi_tpu.envs.door_hand import DoorHand as JaxDoorHand
from ppi_tpu.mpc import Mpc as JaxMpc
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.envs.base import rollout
from ppi_tpu_torch.envs.door_hand import (
    DOOR, FRAME, FRAME_RANGE, LATCH, N_ACT, DoorHand, DoorHandState)
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    kernel_mpc_objective, kernel_step)
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.policies import design_moments, make_policy
from ppi_tpu_torch.runners import run_mpc

N, H = 8, 4


@pytest.fixture(scope="module")
def jenv():
    return JaxDoorHand(engine="tensor")


@pytest.fixture(scope="module")
def lanes(jenv):
    """(JAX state, q0, qd0, actions, clamped lanes, free lanes)."""
    return hand_door_lanes(jenv, DoorHand(), N, H)


@pytest.fixture(scope="module")
def reference(jenv, lanes):
    js, q0, qd0, acts, _, _ = lanes
    return jax_lane_rollout_fn(jenv)(js, q0, qd0, acts)


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, DoorHand())


@pytest.mark.parametrize("digit", ["two_hinge", "three_hinge"])
def test_hand_builders_match_reference(digit):
    """``envs.hand`` against ``ppi_tpu.envs.hand``: one digit of each kind
    on a base body, with the standard contact spheres, off-axis mounts and
    a pen-style direction."""
    import ppi_tpu.envs.hand as jax_hand
    from ppi_tpu.envs.physics import ModelBuilder as JaxModelBuilder
    from ppi_tpu_torch.envs import hand
    from ppi_tpu_torch.envs.physics.engine import HINGE, ModelBuilder

    def build(mod, builder):
        b = builder()
        b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 1.0), mass=1.0)
        if digit == "two_hinge":
            mcp, pip = mod.add_digit(b, 0, (0.1, 0.02, -0.03), (0, 1, 0),
                                     (-0.3, 1.6), (0.0, 1.8),
                                     direction=(0.0, 0.0, -1.0))
        else:
            _, mcp, pip = mod.add_digit3(b, 0, (0.1, 0.02, 0.03), (0, 0, 1),
                                         (0, 1, 0), (-0.25, 0.25),
                                         (-0.3, 1.6), (0.0, 1.8))
        mod.digit_spheres(b, mcp, pip, direction=(0.6, 0.0, 0.8))
        return b.finalize()

    assert_model_equals_reference(
        type("Env", (), {"_model": build(jax_hand, JaxModelBuilder)}),
        type("Env", (), {"_model": build(hand, ModelBuilder)}))


def test_reset_and_frame_match_reference(jenv):
    js = jenv.reset(jax.random.key(3))
    s = DoorHand().reset(None, "cpu", frame=np.asarray(js.frame))
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.physics.qvel),
                                  np.asarray(js.physics.qvel))
    np.testing.assert_array_equal(to_np(s.frame), np.asarray(js.frame))
    # the converter carries the JAX state across field by field
    ps = port_state(DoorHandState, js)
    np.testing.assert_array_equal(to_np(ps.frame), np.asarray(js.frame))
    assert int(ps.t) == 0
    frames = [to_np(DoorHand().reset(torch.Generator().manual_seed(k),
                                     "cpu").frame) for k in (1, 2)]
    assert not np.allclose(*frames)
    for f in frames:
        assert np.all(np.abs(f - np.array(FRAME)) <= np.array(FRAME_RANGE))
    fixed = DoorHand(fixed_scene=True).reset(None, "cpu")
    np.testing.assert_array_equal(to_np(fixed.frame), np.asarray(
        JaxDoorHand(engine="tensor", fixed_scene=True).reset(
            jax.random.key(0)).frame))


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, DoorHand())


@pytest.mark.parametrize("case", ["bolted", "unlatched", "ajar"])
def test_projection_matches_reference(jenv, case):
    """tests/test_door_hand.py's three cases: clamped while latched and
    starting closed; free with the latch pressed or the door ajar."""
    assert_hand_projection_matches(jenv, DoorHand(), case)


def test_plain_rollout_matches_reference(lanes, reference):
    js, q0, qd0, acts, _, _ = lanes
    assert_rollout_close(wrapper_run(DoorHand(), port_state(DoorHandState, js),
                                     acts, q0, qd0), reference)


def test_clamp_fires_in_bolted_lanes_only(lanes, reference):
    js, q0, qd0, acts, clamped, free = lanes
    env = DoorHand()
    _, qf, qdf = wrapper_run(env, port_state(DoorHandState, js), acts, q0,
                             qd0)
    np.testing.assert_array_equal(qf[clamped, DOOR],
                                  np.float32(env.bolt_depth))
    assert np.all(qdf[clamped, DOOR] <= 0.0)
    assert np.all(qf[free, DOOR] > env.bolt_depth + 0.02)
    np.testing.assert_array_equal(reference[1][clamped, DOOR],
                                  np.float32(env.bolt_depth))


def test_eager_step_rollout_matches_reference(lanes, reference):
    """The port's eager env step over N lanes (``plain_step``)."""
    js, q0, qd0, acts, _, _ = lanes
    s = port_state(DoorHandState, js)
    states = s.__class__(physics=s.physics.__class__(
        qpos=to_torch(q0), qvel=to_torch(qd0)), frame=s.frame, t=s.t)
    final, rew = rollout(DoorHand(), states, to_torch(acts))
    assert_rollout_close((to_np(rew), to_np(final.physics.qpos),
                          to_np(final.physics.qvel)), reference)
    assert int(final.t) == H


def test_kernel_step_on_cpu_is_the_eager_step(lanes):
    js, q0, _, acts, _, _ = lanes
    env, s = DoorHand(), port_state(DoorHandState, js)
    s = s.__class__(physics=s.physics.__class__(
        qpos=to_torch(q0[4]), qvel=s.physics.qvel), frame=s.frame, t=s.t)
    s1, r1 = env.step(s, to_torch(acts[4, 0]))
    q, qd, r2 = kernel_step(env, s, to_torch(acts[4, 0]))
    assert r2.shape == () and int(s1.t) == 1
    assert torch.equal(q, s1.physics.qpos) and torch.equal(qd, s1.physics.qvel)
    assert torch.equal(r1, r2)


def test_kernel_objective_costs_match_reference(jenv, lanes):
    js, _, _, acts, _, _ = lanes
    rew, _, _ = jax_lane_rollout_fn(jenv)(
        js, np.tile(np.asarray(js.physics.qpos), (N, 1)),
        np.zeros((N, 12), np.float32), acts)
    s = port_state(DoorHandState, js)
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    costs = kernel_mpc_objective(DoorHand(), s, H)(None, to_torch(acts))
    masked = kernel_mpc_objective(DoorHand(), s, H, to_torch(mask))(
        None, to_torch(acts))
    np.testing.assert_allclose(to_np(costs), -rew.sum(1), **REW_TOL)
    np.testing.assert_allclose(to_np(masked), -(rew * mask).sum(1), **REW_TOL)


def test_nan_lane_goes_nan_alone(lanes):
    js, q0, qd0, acts, _, _ = lanes
    s = port_state(DoorHandState, js)
    bad = qd0.copy()
    bad[2, LATCH] = np.nan
    rew, _, _ = wrapper_run(DoorHand(), s, acts, q0, bad)
    clean, _, _ = wrapper_run(DoorHand(), s, acts, q0, qd0)
    assert np.isnan(rew[2]).all()
    keep = np.arange(N) != 2
    np.testing.assert_array_equal(rew[keep], clean[keep])


def test_observe_and_success_match_reference(jenv, lanes):
    js = lanes[0]
    env = DoorHand()
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[DOOR] = 1.4   # swung open past the success angle
    for q, want in ((np.asarray(js.physics.qpos), False), (qpos, True)):
        jst = js.replace(physics=js.physics.replace(qpos=jnp.asarray(q)))
        st = port_state(DoorHandState, jst)
        np.testing.assert_allclose(to_np(env.observe(st)),
                                   np.asarray(jenv.observe(jst)), rtol=1e-5,
                                   atol=1e-6)
        assert bool(env.success(st)) == bool(jenv.success(jst)) == want


def test_host_c_build_matches_plain(lanes):
    """The projection variant of the kernel body at 12 DoF, as host C, on
    clamped, free and NaN lanes."""
    js, q0, qd0, acts, _, _ = lanes
    bad = q0.copy()
    bad[1, 0] = np.nan
    assert_host_c_matches_plain(DoorHand(), port_state(DoorHandState, js),
                                acts[:, :3], bad, qd0)


# ---- the slice as a whole: a T=3 MPC episode against the JAX agent ---------

MPC_N, MPC_H, MPC_T = 16, 8, 3


def _mpc_episodes():
    z = np.random.default_rng(0).standard_normal(
        (MPC_N, MPC_H * N_ACT)).astype(np.float32)
    jenv = JaxDoorHand(engine="tensor", fixed_scene=True)
    jm, jci, jco = jax_design_moments(jenv.action_low, jenv.action_high,
                                      1000.0)
    jfam, jpol = jax_make_policy(
        "SquaredExponentialKernel", jenv.dt * jnp.arange(MPC_H), N_ACT, jm,
        jci, jco, lengthscale=0.08, lower=jenv.action_low,
        upper=jenv.action_high)
    jagent = JaxMpc(env=jenv, solver=jax_make_solver("Lbps", delta=0.9),
                    family=jfam, timesteps=MPC_T, horizon=MPC_H,
                    n_samples=MPC_N, n_iters=2, anneal=0.5, use_pallas=False)
    env = DoorHand(fixed_scene=True)
    m, ci, co = design_moments(env.action_low, env.action_high, 1000.0)
    fam, pol = make_policy(
        "SquaredExponentialKernel", env.dt * torch.arange(MPC_H), N_ACT, m,
        ci, co, lengthscale=0.08, lower=env.action_low,
        upper=env.action_high, device="cpu")
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
        s = env.reset(None, "cpu")
        carry, _ = agent.warm_start(carry, s, 2)
        _, final, track = agent.run_episode(carry, s)
    return (jtrack, jfinal), (track, final)


def test_mpc_episode_matches_reference():
    (jtrack, jfinal), (track, final) = _mpc_episodes()
    assert track["action"].shape == (MPC_T, N_ACT)
    np.testing.assert_allclose(to_np(track["action"]),
                               np.asarray(jtrack["action"]), atol=5e-4)
    np.testing.assert_allclose(to_np(track["reward"]),
                               np.asarray(jtrack["reward"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(final.physics.qpos),
                               np.asarray(jfinal.physics.qpos), atol=1e-3)
    # the observation's arm velocities reach ~2 rad/s
    np.testing.assert_allclose(to_np(track["obs"]), np.asarray(jtrack["obs"]),
                               rtol=1e-3, atol=1e-3)


def test_runner_runs_door_hand_on_cpu():
    args = run_mpc.build_parser().parse_args([
        "Lbps", "door-v0-hand", "SquaredExponentialKernel", "--delta", "0.9",
        "--n-iters", "2", "--anneal", "0.5", "--lengthscale", "0.08",
        "--horizon", "4", "--timesteps", "2", "--n-warmstart-iters", "1",
        "--device", "cpu", "MonteCarlo", "--n-samples", "8"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success is False
    assert track["action"].shape == (2, N_ACT)
    assert bool(torch.isfinite(track["obs"]).all())
