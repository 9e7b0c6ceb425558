"""cheetah: the port's env and rollout against the JAX package.

The reward takes the step's raw action: its control cost clips it to the
+-30 torque box. The actions here reach past the box in many cells, so the
clip inside the reward is exercised as JAX runs it. Two starts from the JAX
reset's noise (keys 0 and 1). Tolerances are tests/test_torch_rollout.py's
(tests/torch_env_helpers.py).
"""

import jax
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    REW_TOL, assert_host_c_matches_plain, assert_model_equals_reference,
    assert_rollout_close, assert_steps_through_env_step, jax_rollout_fn,
    port_state, wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.cheetah import Cheetah as JaxCheetah
from ppi_tpu_torch.envs.base import batch_rollout
from ppi_tpu_torch.envs.cheetah import Cheetah, CheetahState
from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_mpc_objective
from ppi_tpu_torch.runners import run_mpc

N, H = 12, 3
STARTS = (0, 1)   # JAX reset keys
NAN_LANE = 2


@pytest.fixture(scope="module")
def acts():
    """Torques of scale 25: about a quarter of the cells past +-30."""
    return (25.0 * np.random.default_rng(0).standard_normal(
        (N, H, 6))).astype(np.float32)


@pytest.fixture(scope="module")
def reference(acts):
    """{start: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    jenv = JaxCheetah()
    run = jax_rollout_fn(jenv)
    out = {}
    for key in STARTS:
        js = jenv.reset(jax.random.key(key))
        out[key] = (js, run(js, acts))
    return out


def test_model_matches_reference():
    assert_model_equals_reference(JaxCheetah(), Cheetah())


def test_reset():
    fixed = Cheetah(fixed_init=True).reset(None, "cpu")
    np.testing.assert_array_equal(to_np(fixed.physics.qpos), np.asarray(
        JaxCheetah(fixed_init=True).reset(jax.random.key(0)).physics.qpos))
    s = Cheetah().reset(torch.Generator().manual_seed(0), "cpu")
    assert np.all(np.abs(to_np(s.physics.qpos - fixed.physics.qpos)) <= 0.1)
    assert float(s.physics.qvel.abs().max()) > 0.0


def test_actions_reach_past_the_torque_box(acts):
    assert 0.1 < np.mean(np.abs(acts) > 30.0) < 0.5


@pytest.mark.parametrize("start", STARTS)
def test_plain_rollout_matches_reference(reference, acts, start):
    js, ref = reference[start]
    assert_rollout_close(
        wrapper_run(Cheetah(), port_state(CheetahState, js), acts), ref)


@pytest.mark.parametrize("start", STARTS)
def test_batch_rollout_matches_reference(reference, acts, start):
    """The port's eager env step over N lanes."""
    js, ref = reference[start]
    final, rew = batch_rollout(Cheetah(), port_state(CheetahState, js),
                               to_torch(acts))
    assert_rollout_close((to_np(rew), to_np(final.physics.qpos),
                          to_np(final.physics.qvel)), ref)


def test_real_step_goes_through_env_step(reference, acts):
    """``step`` is ``rollout_kernel.env_step``: one launch of the kernel
    on a CUDA state, the raw action passed to the reward; on the CPU the
    eager step that the batch rollout above holds to the JAX env's
    step."""
    js, _ = reference[STARTS[1]]
    assert_steps_through_env_step(
        Cheetah(), port_state(CheetahState, js),
        np.asarray(js.physics.qpos), acts[5, 0])


@pytest.mark.parametrize("start", STARTS)
def test_kernel_objective_costs_match_reference(reference, acts, start):
    js, (rew, _, _) = reference[start]
    costs = kernel_mpc_objective(
        Cheetah(), port_state(CheetahState, js), H)(None, to_torch(acts))
    np.testing.assert_allclose(to_np(costs), -rew.sum(1), **REW_TOL)


def test_reward_takes_the_raw_action(reference, acts):
    """The reward sees the raw action and clips it itself: clipping the
    actions first changes nothing, while the action does enter the
    reward (a zero action gives another one)."""
    s = port_state(CheetahState, reference[0][0])
    rew, qf, _ = wrapper_run(Cheetah(), s, acts)
    rew_c, qf_c, _ = wrapper_run(Cheetah(), s, np.clip(acts, -30.0, 30.0))
    np.testing.assert_array_equal(rew, rew_c)
    np.testing.assert_array_equal(qf, qf_c)
    env = Cheetah()
    m = env._soa
    q = s.physics.qpos.expand(N, -1).unbind(-1)
    qd = s.physics.qvel.expand(N, -1).unbind(-1)
    act = to_torch(acts[:, 0]).unbind(-1)
    r = env.scalar_reward(m, q, qd, act)
    r0 = env.scalar_reward(m, q, qd, tuple(torch.zeros_like(a) for a in act))
    ctrl = np.mean(np.clip(acts[:, 0], -30, 30) ** 2 / 900.0, axis=1)
    np.testing.assert_allclose(to_np(r0 - r), 0.1 * ctrl, rtol=1e-5)


def test_nan_lane_goes_nan_alone(reference, acts):
    s = port_state(CheetahState, reference[1][0])
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[NAN_LANE, 5] = np.nan
    rew, _, _ = wrapper_run(Cheetah(), s, acts, q0=q0)
    clean, _, _ = wrapper_run(Cheetah(), s, acts)
    assert np.isnan(rew[NAN_LANE]).all()
    keep = np.arange(N) != NAN_LANE
    np.testing.assert_array_equal(rew[keep], clean[keep])


def test_host_c_build_matches_plain(reference):
    """The action-reward variant of the kernel body, as host C."""
    s = port_state(CheetahState, reference[1][0])
    rng = np.random.default_rng(2)
    n, h = 8, 3
    acts = (25.0 * rng.standard_normal((n, h, 6))).astype(np.float32)
    q0 = np.tile(to_np(s.physics.qpos), (n, 1))
    q0[6, 2] = np.nan
    qd0 = np.tile(to_np(s.physics.qvel), (n, 1))
    assert_host_c_matches_plain(Cheetah(), s, acts, q0, qd0)


def test_observe_matches_reference(reference):
    js = reference[0][0]
    np.testing.assert_array_equal(
        to_np(Cheetah().observe(port_state(CheetahState, js))),
        np.asarray(JaxCheetah().observe(js)))
    assert not hasattr(Cheetah(), "success")


def test_runner_runs_cheetah_on_cpu():
    args = run_mpc.build_parser().parse_args([
        "Mppi", "cheetah", "ColouredNoise", "--beta", "2", "--horizon", "4",
        "--timesteps", "3", "--n-warmstart-iters", "1", "--device", "cpu",
        "MonteCarlo", "--n-samples", "8"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret) and success is None
    assert track["action"].shape == (3, 6)
    assert bool(torch.isfinite(track["obs"]).all())
