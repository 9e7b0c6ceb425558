"""hammer-v0-hand: the port's env and rollout against the JAX package.

The JAX reference is ``HammerHand(engine="tensor")``, the JAX package's CPU
test engine (its scalar program takes tens of minutes to compile on the
CPU at 10 DoF). The first half of the lanes starts from the reset posture
(the free hammer resting on the bench: the bench contacts); in the second
half the hammer starts with its head 1 cm over the nail, falling at 2 m/s,
and drives the friction-held nail in (the strike contact, the nail's
Coulomb clip). Two boards: one sampled by the JAX reset, one pinned 3 cm
lower. The tensor engine assembles the same dynamics in another order and
the impact amplifies the rounding, so this scene's tolerances are wider
than the other hand scenes': rewards 1e-6 relative and 1e-5 absolute (the
reward pays 50 per metre of nail depth; measured 2.9e-6), positions 1e-5
relative and 5e-6 absolute (measured 2.5e-6, on the hammer's pitch),
velocities 2e-4 (measured 1.4e-4 on the struck hammer; 2.7e-5 with the
board 3 cm higher), at N=8, H=4.
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
    assert_observe_and_success_match, jax_lane_rollout_fn, lane_states, port_state, run_on_cpu, wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.hammer_hand import HammerHand as JaxHammerHand
from ppi_tpu.envs.physics import ModelBuilder as JaxModelBuilder
from ppi_tpu_torch.envs.base import rollout
from ppi_tpu_torch.envs.hammer_hand import (
    BENCH_Z, BOARD_POS, BOARD_Z_SPAN, GRIP_START, HAM_P, HAM_X, HAM_Z,
    HEAD_LOCAL, N_ACT, NAIL, NAIL_X, HammerHand, HammerHandState)
from ppi_tpu_torch.envs.physics.engine import HINGE, ModelBuilder

N, H = 8, 4
TOL = dict(rtol=1e-5, atol=5e-6)
REW_TOL = dict(rtol=1e-6, atol=1e-5)
VEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], **REW_TOL)
    np.testing.assert_allclose(got[1], ref[1], **TOL)
    np.testing.assert_allclose(got[2], ref[2], **VEL_TOL)


@pytest.fixture(scope="module")
def jenv():
    return JaxHammerHand(engine="tensor")


def _lanes(jstate):
    """(q0, qd0, actions) for the board of ``jstate``."""
    q0 = np.tile(np.asarray(jstate.physics.qpos), (N, 1))
    qd0 = np.zeros_like(q0)
    head_z = float(jstate.board[2]) + 0.06 + 0.018 + 0.045 + 0.01
    q0[N // 2:, HAM_X] = NAIL_X - HEAD_LOCAL[0] - GRIP_START[0]
    q0[N // 2:, HAM_Z] = head_z - HEAD_LOCAL[2] - GRIP_START[1]
    qd0[N // 2:, HAM_Z] = -2.0
    acts = (q0[:, None, :N_ACT] + 0.3 * np.random.default_rng(0)
            .standard_normal((N, H, N_ACT))).astype(np.float32)
    return q0, qd0, acts


@pytest.fixture(scope="module")
def reference(jenv):
    """{board: (JAX state, lanes, (rewards, qf, qdf))}, one JAX compile."""
    run = jax_lane_rollout_fn(jenv)
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, dz in (("sampled", 0.0), ("lower", -0.03)):
        js = s0.replace(board=s0.board + jnp.array([0.0, 0.0, dz]))
        lanes = _lanes(js)
        out[name] = (js, lanes, run(js, *lanes))
    return out


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, HammerHand())


def test_planar_base_matches_reference():
    """``ModelBuilder.add_planar_base`` against the JAX package's: two
    near-massless slides, with other axes than the hammer's."""
    def build(cls):
        b = cls()
        base = b.add_planar_base(offset_pos=(0.1, 0.2, 0.3), mass=2e-3,
                                 axis_forward=(0, 1, 0), axis_up=(1, 0, 0))
        b.add_body(parent=base, joint_type=HINGE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 0), mass=0.3)
        return base, b.finalize()

    (jbase, jmodel), (base, model) = build(JaxModelBuilder), build(ModelBuilder)
    assert base == jbase == 1
    assert_model_equals_reference(type("Env", (), {"_model": jmodel}),
                                  type("Env", (), {"_model": model}))


def test_reset_and_board_match_reference(jenv):
    js = jenv.reset(jax.random.key(3))
    s = HammerHand().reset(None, "cpu", board=np.asarray(js.board))
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.board), np.asarray(js.board))
    ps = port_state(HammerHandState, js)
    np.testing.assert_array_equal(to_np(ps.board), np.asarray(js.board))
    boards = [to_np(HammerHand().reset(torch.Generator().manual_seed(k),
                                       "cpu").board) for k in (1, 2)]
    assert not np.allclose(*boards)
    for b in boards:
        np.testing.assert_array_equal(b[:2],
                                      np.array(BOARD_POS[:2], np.float32))
        assert BENCH_Z <= b[2] <= BENCH_Z + BOARD_Z_SPAN
    fixed = HammerHand(fixed_scene=True).reset(None, "cpu")
    np.testing.assert_array_equal(to_np(fixed.board), np.asarray(
        JaxHammerHand(engine="tensor", fixed_scene=True).reset(
            jax.random.key(0)).board))


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, HammerHand())


@pytest.mark.parametrize("board", ["sampled", "lower"])
def test_plain_rollout_matches_reference(reference, board):
    js, (q0, qd0, acts), ref = reference[board]
    _close(wrapper_run(HammerHand(), port_state(HammerHandState, js), acts,
                       q0, qd0), ref)


def test_the_dropped_hammer_drives_the_nail(reference):
    """Gravity cannot seat the friction-held nail; the falling head does."""
    _, _, (rew, qf, _) = reference["sampled"]
    np.testing.assert_array_equal(qf[:N // 2, NAIL], 0.0)
    assert np.all(qf[N // 2:, NAIL] > 0.01)
    assert np.all(rew[N // 2:, -1] > rew[:N // 2, -1] + 0.5)
    assert np.all(np.abs(qf[N // 2:, HAM_P]) > 1e-3)   # the impact pitches it


def test_boards_change_the_rollout(reference):
    (_, _, (ra, qa, _)), (_, _, (rb, qb, _)) = (reference["sampled"],
                                                reference["lower"])
    # the nail moves with its board, and with it the head-to-nail term of
    # every lane; the falling hammers end elsewhere too
    assert np.all(np.abs(ra.sum(1) - rb.sum(1)) > 1e-3)
    assert np.all(np.abs(qa[N // 2:, HAM_Z] - qb[N // 2:, HAM_Z]) > 1e-3)


def test_step_over_lanes_matches_reference(reference):
    js, lanes, ref = reference["sampled"]
    final, rew = rollout(HammerHand(), lane_states(
        port_state(HammerHandState, js), lanes[0], lanes[1]),
        to_torch(lanes[2]))
    _close((to_np(rew), to_np(final.physics.qpos), to_np(final.physics.qvel)),
           ref)
    assert int(final.t) == H


def test_kernel_step_on_cpu_is_the_eager_step(reference):
    js, (q0, _, acts), _ = reference["lower"]
    assert_kernel_step_is_the_eager_step(
        HammerHand(), port_state(HammerHandState, js), q0[5], acts[5, 0])


def test_kernel_objective_costs_match_reference(jenv, reference):
    js, (_, _, acts), _ = reference["lower"]
    q = np.tile(np.asarray(js.physics.qpos), (N, 1))
    rew, _, _ = jax_lane_rollout_fn(jenv)(js, q, np.zeros_like(q), acts)
    assert_objective_costs_match(HammerHand(),
                                 port_state(HammerHandState, js), acts, rew)


def test_nan_lane_goes_nan_alone(reference):
    js, (q0, qd0, acts), _ = reference["sampled"]
    assert_nan_lane_goes_nan_alone(
        HammerHand(), port_state(HammerHandState, js), acts, q0, qd0)


def test_observe_success_and_lifted_match_reference(jenv, reference):
    js = reference["sampled"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[NAIL], qpos[HAM_Z] = 0.058, 0.05   # nail seated, hammer held up
    done = js.replace(physics=js.physics.replace(qpos=jnp.asarray(qpos)))
    env = HammerHand()
    assert_observe_and_success_match(jenv, env, HammerHandState,
                                     [(js, False), (done, True)])
    for jst, want in ((js, False), (done, True)):
        st = port_state(HammerHandState, jst)
        assert bool(env.lifted(st)) == bool(jenv.lifted(jst)) == want


def test_host_c_build_matches_plain(reference):
    """The 10-DoF body (planar free hammer, friction clip, ``maximum`` and
    the comparisons of the reward), as host C, on resting, striking and NaN
    lanes, one of them with the grip point outside its workspace. libm's
    and torch's sin and cos differ by an ulp, which the impact amplifies:
    measured 2.0e-4 on a velocity of 5.1 after 3 steps, held to 1e-4
    relative and absolute."""
    js, (q0, qd0, acts), _ = reference["sampled"]
    bad = q0.copy()
    bad[1, 0] = np.nan
    bad[2, HAM_X] = 0.5   # grip x = 0.94 > 0.80: the knock-away cost
    assert_host_c_matches_plain(HammerHand(), port_state(HammerHandState, js),
                                acts[:, :3], bad, qd0,
                                tol=dict(rtol=1e-4, atol=1e-4))


def test_runner_runs_hammer_hand_on_cpu():
    run_on_cpu(["Lbps", "hammer-v0-hand", "SquaredExponentialKernel",
                "--delta", "0.9", "--n-iters", "2", "--anneal", "0.5",
                "--lengthscale", "0.08"], N_ACT)
