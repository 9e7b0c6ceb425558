"""hammer-v0: the port's env, rollout and the ``make mpc-essps`` path
against the JAX package.

The JAX reference is ``Hammer()`` on its scalar-SoA path (5 DoF jits in
seconds). Two boards: "under" puts the nail 2 mm under the hammer head's
reset position, so arms that swing down drive the friction-held nail (the
strike contact, the Coulomb clip and the depth bonuses all act); "sampled"
is a board drawn by the JAX reset. Tolerances are
tests/test_torch_rollout.py's (tests/torch_env_helpers.py): measured
2.6e-6 in the rewards (of up to 16), 2.4e-7 in the positions and 4.8e-6
in the velocities at N=8, H=6. The T=3
MPC comparison (Essps + RffFeatures, 5 quadrature nodes so that N=16
samples can fit the 10 weight dimensions) holds the actions to 5e-4: the
Essps root search sits on min-max-normalized costs, as LBPS's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    REW_TOL, assert_host_c_matches_plain, assert_model_equals_reference,
    assert_nan_lane_goes_nan_alone, assert_rollout_close, jax_rollout_fn,
    mpc_episode_pair, port_state, wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.hammer import Hammer as JaxHammer
from ppi_tpu_torch.envs.base import batch_rollout
from ppi_tpu_torch.envs.hammer import (
    NAIL, NAIL_DEPTH, NAIL_POS, NAIL_Z_RANGE, Hammer, HammerState)
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    kernel_mpc_objective, kernel_step)
from ppi_tpu_torch.runners import run_mpc

N, H = 8, 6


def _board_under_head():
    env = Hammer()
    s = env.reset(None, "cpu", board=(0.0, 0.0, 0.0))
    head, nail = env._sites(s.physics.qpos, s.board)
    return to_np(head - nail) - np.array([0.0, 0.0, 0.065], np.float32)


@pytest.fixture(scope="module")
def acts():
    q0 = np.array([0.0, 0.3, -1.6, 0.9], np.float32)
    return (q0 + 0.4 * np.random.default_rng(0).standard_normal(
        (N, H, 4))).astype(np.float32)


@pytest.fixture(scope="module")
def reference(acts):
    """{board: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    jenv = JaxHammer()
    run = jax_rollout_fn(jenv)
    s0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, board in (("under", jnp.asarray(_board_under_head())),
                        ("sampled", s0.board)):
        js = s0.replace(board=board)
        out[name] = (js, run(js, acts))
    return out


def test_model_matches_reference():
    assert_model_equals_reference(JaxHammer(), Hammer())


def test_reset_and_board_match_reference():
    js = JaxHammer().reset(jax.random.key(3))
    s = Hammer().reset(None, "cpu", board=np.asarray(js.board))
    np.testing.assert_array_equal(to_np(s.physics.qpos),
                                  np.asarray(js.physics.qpos))
    np.testing.assert_array_equal(to_np(s.board), np.asarray(js.board))
    ps = port_state(HammerState, js)
    np.testing.assert_array_equal(to_np(ps.board), np.asarray(js.board))
    boards = [to_np(Hammer().reset(torch.Generator().manual_seed(k),
                                   "cpu").board) for k in (1, 2)]
    assert not np.allclose(*boards)
    for b in boards:
        np.testing.assert_array_equal(b[:2], np.array(NAIL_POS[:2], np.float32))
        assert abs(b[2] - NAIL_POS[2]) <= NAIL_Z_RANGE
    fixed = Hammer(fixed_scene=True).reset(None, "cpu")
    np.testing.assert_array_equal(to_np(fixed.board), np.asarray(
        JaxHammer(fixed_scene=True).reset(jax.random.key(0)).board))


@pytest.mark.parametrize("board", ["under", "sampled"])
def test_plain_rollout_matches_reference(reference, acts, board):
    js, ref = reference[board]
    assert_rollout_close(wrapper_run(Hammer(), port_state(HammerState, js),
                                     acts), ref)


def test_the_nail_is_driven_under_the_head_only(reference):
    """The friction-held nail moves only by impact: some arms drive it past
    the half-depth bonus under the head; none reaches the sampled board."""
    under, sampled = reference["under"][1], reference["sampled"][1]
    assert np.sum(under[1][:, NAIL] > 0.5 * NAIL_DEPTH) >= 2
    assert np.all(under[1][:, NAIL] >= 0.0)
    np.testing.assert_array_equal(sampled[1][:, NAIL], 0.0)
    assert under[0].max() > 2.0   # the +2 bonus was paid


@pytest.mark.parametrize("board", ["under", "sampled"])
def test_step_over_lanes_matches_reference(reference, acts, board):
    """The port's env step over N lanes (on the CPU, ``plain_step``)."""
    js, ref = reference[board]
    final, rew = batch_rollout(Hammer(), port_state(HammerState, js),
                               to_torch(acts))
    assert_rollout_close((to_np(rew), to_np(final.physics.qpos),
                          to_np(final.physics.qvel)), ref)
    assert int(final.t) == H


def test_step_matches_the_reference_step(reference, acts):
    """One real step from a single state against the JAX env's ``step``
    (its own torque and reward code, not the scalar contract's)."""
    js = reference["under"][0]
    jnext, jr = JaxHammer().step(js, jnp.asarray(acts[0, 0]))
    env, s = Hammer(), port_state(HammerState, js)
    nxt, r = env.step(s, to_torch(acts[0, 0]))
    np.testing.assert_allclose(to_np(nxt.physics.qpos),
                               np.asarray(jnext.physics.qpos), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(nxt.physics.qvel),
                               np.asarray(jnext.physics.qvel), **REW_TOL)
    np.testing.assert_allclose(float(r), float(jr), **REW_TOL)
    q, qd, r2 = kernel_step(env, s, to_torch(acts[0, 0]))
    assert r2.shape == () and int(nxt.t) == 1
    assert torch.equal(q, nxt.physics.qpos) and torch.equal(r, r2)
    same, _ = env.plain_step(s, to_torch(acts[0, 0]))
    assert torch.equal(same.physics.qvel, nxt.physics.qvel)


@pytest.mark.parametrize("board", ["under", "sampled"])
def test_kernel_objective_costs_match_reference(reference, acts, board):
    js, (rew, _, _) = reference[board]
    s = port_state(HammerState, js)
    mask = np.array([1.0] * 4 + [0.0] * 2, np.float32)
    costs = kernel_mpc_objective(Hammer(), s, H)(None, to_torch(acts))
    masked = kernel_mpc_objective(Hammer(), s, H, to_torch(mask))(
        None, to_torch(acts))
    np.testing.assert_allclose(to_np(costs), -rew.sum(1), **REW_TOL)
    np.testing.assert_allclose(to_np(masked), -(rew * mask).sum(1),
                               **REW_TOL)


def test_boards_change_the_costs(reference, acts):
    costs = [to_np(kernel_mpc_objective(
        Hammer(), port_state(HammerState, reference[b][0]), H)(
            None, to_torch(acts))) for b in ("under", "sampled")]
    assert np.all(np.abs(costs[0] - costs[1]) > 1e-3)


def test_nan_lane_goes_nan_alone(reference, acts):
    assert_nan_lane_goes_nan_alone(
        Hammer(), port_state(HammerState, reference["under"][0]), acts)


def test_host_c_build_matches_plain(reference, acts):
    """The friction clip and the depth comparisons of the generated body,
    as host C, on driven, idle and NaN lanes."""
    s = port_state(HammerState, reference["under"][0])
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[5, 1] = np.nan
    q0[6, NAIL] = 0.029   # a nail about to cross the half-depth bonus
    qd0 = np.zeros_like(q0)
    qd0[6, NAIL] = 0.5
    assert_host_c_matches_plain(Hammer(), s, acts[:, :4], q0, qd0)


def test_observe_and_success_match_reference(reference):
    jenv, env = JaxHammer(), Hammer()
    js = reference["sampled"][0]
    qpos = np.asarray(js.physics.qpos).copy()
    qpos[NAIL] = 0.058   # seated past 0.95 of the depth
    for q, want in ((np.asarray(js.physics.qpos), False), (qpos, True)):
        jst = js.replace(physics=js.physics.replace(qpos=jnp.asarray(q)))
        st = port_state(HammerState, jst)
        np.testing.assert_allclose(to_np(env.observe(st)),
                                   np.asarray(jenv.observe(jst)), rtol=1e-5,
                                   atol=1e-6)
        assert bool(env.success(st)) == bool(jenv.success(jst)) == want


# ---- the slice as a whole: make mpc-essps at T=3 against the JAX agent -----

def test_mpc_essps_episode_matches_reference():
    (jtrack, jfinal), (track, final) = mpc_episode_pair(
        JaxHammer(fixed_scene=True), Hammer(fixed_scene=True),
        "Essps", "RffFeatures", dict(order=5, lengthscale=0.15),
        dict(n_elites=10), n_samples=16, horizon=8, timesteps=3, n_iters=1,
        anneal=1.0)
    assert track["action"].shape == (3, 4)
    np.testing.assert_allclose(to_np(track["action"]),
                               np.asarray(jtrack["action"]), atol=5e-4)
    np.testing.assert_allclose(to_np(track["reward"]),
                               np.asarray(jtrack["reward"]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(final.physics.qpos),
                               np.asarray(jfinal.physics.qpos), atol=1e-3)
    np.testing.assert_allclose(to_np(track["obs"]), np.asarray(jtrack["obs"]),
                               rtol=1e-3, atol=1e-3)
    # the posterior moved: the first action is not the prior mean (0)
    assert float(track["action"].abs().max()) > 1e-3


def test_runner_runs_mpc_essps_on_cpu():
    args = run_mpc.build_parser().parse_args([
        "Essps", "hammer-v0", "RffFeatures", "--n-elites", "10",
        "--lengthscale", "0.15", "--order", "5", "--horizon", "8",
        "--timesteps", "3", "--n-warmstart-iters", "2", "--device", "cpu",
        "MonteCarlo", "--n-samples", "16"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success is False
    assert track["action"].shape == (3, 4)
    assert bool(torch.isfinite(track["obs"]).all())


@pytest.mark.parametrize("policy", ["RbfFeatures", "PeriodicKernel"])
def test_runner_spans_and_period(policy, monkeypatch):
    """RBF features span the episode, every other prior the horizon, and
    the periodic kernel's period is the env's dt."""
    seen = {}
    real = run_mpc.make_policy

    def spy(name, time_sequence, *args, **kwargs):
        seen.update(span=len(time_sequence), period=kwargs["period"])
        return real(name, time_sequence, *args, **kwargs)

    monkeypatch.setattr(run_mpc, "make_policy", spy)
    args = run_mpc.build_parser().parse_args([
        "Lbps", "hammer-v0", policy, "--lengthscale", "0.08", "--horizon",
        "4", "--timesteps", "6", "--n-warmstart-iters", "1", "--n-features",
        "3", "--device", "cpu", "mc", "--n-samples", "8"])
    ret, _, track = run_mpc.main(args)
    assert np.isfinite(ret) and track["action"].shape == (6, 4)
    assert seen["span"] == (6 if policy == "RbfFeatures" else 4)
    assert seen["period"] == Hammer().dt
