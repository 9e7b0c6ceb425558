"""hammer-v0-adroit: the port's env and rollout against the JAX package.

The JAX reference is ``HammerAdroit(engine="tensor")``, the JAX package's
CPU test engine (its default, "stacked", is XLA's assembly of the same
dynamics; the port runs the scalar program, whose CPU compile in JAX is
infeasible at 25 DoF), jitted once for the file. The first half of the
lanes starts from the reset posture (the free hammer resting on the bench:
the bench contacts; the open hand above the handle); in the second half
the hammer starts with its head 1 cm over the nail, falling at 2 m/s, and
drives the friction-held nail in (the strike contact, the nail's Coulomb
clip). Two boards: one sampled by the JAX reset, one pinned 3 cm lower.
H=2, not 4: at 465k eager ops a step the file would pass its 90 s.
Tolerances: ``REW_TOL`` and ``Q_TOL`` of tests/torch_env_helpers.py
(measured 1.0e-6 in the rewards, which pay 50 per metre of nail depth, and
1.2e-7 in the positions), and the velocities within hammer-v0-hand's 2e-4
(tests/test_torch_hammer_hand.py: the tensor engine assembles the same
dynamics in another order, and the impact amplifies the rounding;
measured 3.5e-5 on the struck hammer, at N=8, H=2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    REW_TOL, Q_TOL, assert_hand_torque_matches, assert_host_c_matches_plain,
    assert_kernel_step_is_the_eager_step, assert_model_equals_reference,
    assert_nan_lane_goes_nan_alone, assert_objective_costs_match,
    assert_observe_and_success_match, jax_lane_rollout_fn, port_state,
    run_on_cpu, wrapper_run)
from torch_helpers import to_np
from ppi_tpu.envs.hammer_adroit import HammerAdroit as JaxHammerAdroit
from ppi_tpu_torch.envs.hammer_adroit import (
    HAM_P, HAM_X, HAM_Z, N_ACT, NAIL, HammerAdroit, HammerAdroitState)
from ppi_tpu_torch.envs.hammer_hand import (
    BENCH_Z, BOARD_POS, BOARD_Z_SPAN, GRIP_START, HEAD_LOCAL, NAIL_X)

N, H = 8, 2
VEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], **REW_TOL)
    np.testing.assert_allclose(got[1], ref[1], **Q_TOL)
    np.testing.assert_allclose(got[2], ref[2], **VEL_TOL)


@pytest.fixture(scope="module")
def jenv():
    return JaxHammerAdroit(engine="tensor")


@pytest.fixture(scope="module")
def jrun(jenv):
    """The JAX lane rollout, compiled once for every (N, H) call here."""
    return jax_lane_rollout_fn(jenv)


def _lanes(jstate):
    """(q0, qd0, actions) for the board of ``jstate``: actions are the arm's
    and the digits' posture plus 0.3 z."""
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
def reference(jenv, jrun):
    """{board: (JAX state, lanes, (rewards, qf, qdf))}."""
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, dz in (("sampled", 0.0), ("lower", -0.03)):
        js = s0.replace(board=s0.board + jnp.array([0.0, 0.0, dz]))
        lanes = _lanes(js)
        out[name] = (js, lanes, jrun(js, *lanes))
    return out


@pytest.fixture(scope="module")
def plain(reference):
    """{board: the wrapper's CPU path (the plain version) on its lanes}."""
    return {name: wrapper_run(HammerAdroit(),
                              port_state(HammerAdroitState, js), lanes[2],
                              lanes[0], lanes[1])
            for name, (js, lanes, _) in reference.items()}


def test_model_matches_reference(jenv):
    assert_model_equals_reference(jenv, HammerAdroit())


def test_reset_and_board_match_reference(jenv):
    js = jenv.reset(jax.random.key(3))
    s = HammerAdroit().reset(None, "cpu", board=np.asarray(js.board))
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.physics.qvel),
                                  np.asarray(js.physics.qvel))
    assert s.physics.qpos.shape == (25,)
    np.testing.assert_array_equal(to_np(s.board), np.asarray(js.board))
    ps = port_state(HammerAdroitState, js)
    np.testing.assert_array_equal(to_np(ps.board), np.asarray(js.board))
    boards = [to_np(HammerAdroit().reset(torch.Generator().manual_seed(k),
                                         "cpu").board) for k in (1, 2)]
    assert not np.allclose(*boards)
    for b in boards:
        np.testing.assert_array_equal(b[:2],
                                      np.array(BOARD_POS[:2], np.float32))
        assert BENCH_Z <= b[2] <= BENCH_Z + BOARD_Z_SPAN
    fixed = HammerAdroit(fixed_scene=True).reset(None, "cpu")
    np.testing.assert_array_equal(to_np(fixed.board), np.asarray(
        JaxHammerAdroit(engine="tensor", fixed_scene=True).reset(
            jax.random.key(0)).board))
    np.testing.assert_array_equal(to_np(HammerAdroit().action_low),
                                  np.asarray(jenv.action_low))
    np.testing.assert_array_equal(to_np(HammerAdroit().action_high),
                                  np.asarray(jenv.action_high))


def test_torque_matches_reference(jenv):
    assert_hand_torque_matches(jenv, HammerAdroit())


@pytest.mark.parametrize("board", ["sampled", "lower"])
def test_plain_rollout_matches_reference(reference, plain, board):
    _close(plain[board], reference[board][2])


def test_the_dropped_hammer_drives_the_nail(reference):
    """Gravity cannot seat the friction-held nail; the falling head does."""
    _, _, (rew, qf, _) = reference["sampled"]
    np.testing.assert_array_equal(qf[:N // 2, NAIL], 0.0)
    assert np.all(qf[N // 2:, NAIL] > 0.005)
    assert np.all(rew[N // 2:, -1] > rew[:N // 2, -1] + 0.2)
    assert np.all(np.abs(qf[N // 2:, HAM_P]) > 1e-4)   # the impact pitches it


def test_boards_change_the_rollout(reference):
    (_, _, (ra, qa, _)), (_, _, (rb, qb, _)) = (reference["sampled"],
                                                reference["lower"])
    # the nail moves with its board, and with it the head-to-nail term of
    # every lane; the falling hammers end elsewhere too
    assert np.all(np.abs(ra.sum(1) - rb.sum(1)) > 1e-3)
    assert np.all(np.abs(qa[N // 2:, HAM_Z] - qb[N // 2:, HAM_Z]) > 1e-3)


def test_kernel_step_on_cpu_is_the_eager_step(reference):
    js, (q0, _, acts), _ = reference["lower"]
    assert_kernel_step_is_the_eager_step(
        HammerAdroit(), port_state(HammerAdroitState, js), q0[5], acts[5, 0])


def test_kernel_objective_costs_match_reference(jrun, reference):
    js, (_, _, acts), _ = reference["lower"]
    q = np.tile(np.asarray(js.physics.qpos), (N, 1))
    rew, _, _ = jrun(js, q, np.zeros_like(q), acts)
    assert_objective_costs_match(HammerAdroit(),
                                 port_state(HammerAdroitState, js), acts, rew)


def test_nan_lane_goes_nan_alone(reference, plain):
    js, (q0, qd0, acts), _ = reference["sampled"]
    assert_nan_lane_goes_nan_alone(
        HammerAdroit(), port_state(HammerAdroitState, js), acts, q0, qd0,
        clean=plain["sampled"][0])


def test_observe_success_and_lifted_match_reference(jenv, reference):
    js = reference["sampled"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[NAIL], qpos[HAM_Z] = 0.058, 0.05   # nail seated, hammer held up
    done = js.replace(physics=js.physics.replace(qpos=jnp.asarray(qpos)))
    env = HammerAdroit()
    assert_observe_and_success_match(jenv, env, HammerAdroitState,
                                     [(js, False), (done, True)])
    for jst, want in ((js, False), (done, True)):
        st = port_state(HammerAdroitState, jst)
        assert bool(env.lifted(st)) == bool(jenv.lifted(jst)) == want


def test_host_c_build_matches_plain(reference):
    """The 25-DoF body (planar free hammer, friction clip, ``maximum`` and
    the comparisons of the reward), as host C, over 2 steps of resting,
    striking and NaN lanes, one of them with the grip point outside its
    workspace; within hammer-v0-hand's host-C bound (libm's and torch's
    sin and cos differ by an ulp, which the impact amplifies)."""
    js, (q0, qd0, acts), _ = reference["sampled"]
    pick = [0, 1, 2, 5]
    bad = q0[pick].copy()
    bad[1, 0] = np.nan
    bad[2, HAM_X] = 0.5   # grip x = 0.94 > 0.80: the knock-away cost
    assert_host_c_matches_plain(HammerAdroit(),
                                port_state(HammerAdroitState, js), acts[pick],
                                bad, qd0[pick],
                                tol=dict(rtol=1e-4, atol=1e-4))


def test_runner_runs_hammer_adroit_on_cpu():
    run_on_cpu(["Lbps", "hammer-v0-adroit", "SquaredExponentialKernel",
                "--delta", "0.9", "--n-iters", "1", "--anneal", "0.5",
                "--lengthscale", "0.08"], N_ACT, horizon=H)
