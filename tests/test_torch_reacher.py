"""reacher: the port's env and rollout against the JAX package.

The first body whose reward takes both the step's raw action and reward
constants (the target), in that order. Two references: JAX's
``batch_rollout`` (``Reacher.step``, the tensor engine, with its own
``jnp.linalg.norm``) and JAX's own rollout kernel in Pallas interpret mode
(the scalar program, the argument order of the reward included), each at
two targets. The port's step is the scalar program, so it is held to
JAX's tensor-engine step at the looser of tests/test_torch_rollout.py's
tolerances (REW_TOL, positions included); to the Pallas kernel at REW_TOL
and Q_TOL. Actions of scale 1.5 reach past the +-1 torque box in about half
the cells: the torque clips them, the control cost does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_env_helpers import (
    REW_TOL, assert_host_c_matches_plain, assert_kernel_step_is_the_eager_step,
    assert_model_equals_reference, assert_nan_lane_goes_nan_alone,
    assert_objective_costs_match, assert_rollout_close, assert_uniform,
    jax_pallas_rollout_fn, jax_rollout_fn, pinned_jax_state, port_state,
    resets, run_on_cpu, wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.reacher import Reacher as JaxReacher
from ppi_tpu_torch.envs.base import batch_rollout
from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_mpc_objective
from ppi_tpu_torch.envs.reacher import Reacher, ReacherState

N, H = 8, 6
TARGETS = {"sampled": None, "second": (-0.12, 0.1)}


@pytest.fixture(scope="module")
def acts():
    return (1.5 * np.random.default_rng(0).standard_normal(
        (N, H, 2))).astype(np.float32)


@pytest.fixture(scope="module")
def reference(acts):
    """{target: (JAX state, scan rollout, Pallas rollout)}, one compile
    of each."""
    jenv = JaxReacher()
    run, pallas = jax_rollout_fn(jenv), jax_pallas_rollout_fn(jenv)
    js0 = jenv.reset(jax.random.key(0))
    out = {}
    for name, target in TARGETS.items():
        js = js0 if target is None else pinned_jax_state(js0, target=target)
        out[name] = (js, run(js, acts), pallas(js, acts))
    return out


def _state(reference, name):
    return port_state(ReacherState, reference[name][0])


def test_model_matches_reference():
    assert_model_equals_reference(JaxReacher(), Reacher())


def test_reset_distribution():
    """gym Reacher's: qpos U(-0.1, 0.1), qvel U(-5e-3, 5e-3), the target
    uniform over the 0.2 m disk (8-draw first-accept)."""
    states = resets(Reacher())
    assert_uniform([to_np(s.physics.qpos) for s in states], -0.1, 0.1)
    assert_uniform([to_np(s.physics.qvel) for s in states], -5e-3, 5e-3)
    targets = np.stack([to_np(s.target) for s in states])
    r = np.linalg.norm(targets, axis=1)
    assert np.all(r < 0.2)
    # uniform over the disk: r^2 / 0.04 is U(0, 1), the angle uniform
    assert_uniform((r ** 2 / 0.04)[:, None], 0.0, 1.0)
    assert np.all(np.abs(targets.mean(0)) < 4.5 * 0.1 / np.sqrt(len(r)))
    fixed = Reacher(fixed_goal=True).reset(None, "cpu")
    jfixed = JaxReacher(fixed_goal=True).reset(jax.random.key(0))
    np.testing.assert_array_equal(to_np(fixed.target),
                                  np.asarray(jfixed.target))
    np.testing.assert_array_equal(to_np(fixed.physics.qpos),
                                  np.asarray(jfixed.physics.qpos))


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_plain_rollout_matches_the_tensor_engine(reference, acts, target):
    js, ref, _ = reference[target]
    got = wrapper_run(Reacher(), port_state(ReacherState, js), acts)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **REW_TOL)


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_plain_rollout_matches_the_pallas_kernel(reference, acts, target):
    """The scalar program against JAX's kernel body: the raw action ahead
    of the target in the reward's arguments."""
    js, _, ref = reference[target]
    assert_rollout_close(
        wrapper_run(Reacher(), port_state(ReacherState, js), acts), ref)


def test_step_over_lanes_matches_reference(reference, acts):
    js, ref, _ = reference["sampled"]
    final, rew = batch_rollout(Reacher(), port_state(ReacherState, js),
                               to_torch(acts))
    for a, b in zip((rew, final.physics.qpos, final.physics.qvel), ref):
        np.testing.assert_allclose(to_np(a), b, **REW_TOL)
    assert int(final.t) == H


def test_step_matches_the_reference_step(reference, acts):
    jenv, env = JaxReacher(), Reacher()
    js = reference["second"][0]
    jnext, jr = jax.jit(jenv.step)(js, jnp.asarray(acts[1, 0]))
    nxt, r = env.step(port_state(ReacherState, js), to_torch(acts[1, 0]))
    for a, b in ((nxt.physics.qpos, jnext.physics.qpos),
                 (nxt.physics.qvel, jnext.physics.qvel), (r, jr)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **REW_TOL)
    s = port_state(ReacherState, js)
    assert_kernel_step_is_the_eager_step(env, s, to_np(s.physics.qpos),
                                         acts[1, 0])


def test_reward_takes_the_raw_action_and_the_target(reference, acts):
    """Clipping the actions first leaves every state as it is and lowers
    each reward by exactly the control cost of the part past the box;
    the target moves every reward."""
    env, s = Reacher(), _state(reference, "sampled")
    assert 0.3 < np.mean(np.abs(acts) > 1.0) < 0.7
    rew, qf, qdf = wrapper_run(env, s, acts)
    clipped = np.clip(acts, -1.0, 1.0)
    rew_c, qf_c, qdf_c = wrapper_run(env, s, clipped)
    np.testing.assert_array_equal(qf, qf_c)
    np.testing.assert_array_equal(qdf, qdf_c)
    extra = 0.01 * ((acts ** 2).sum(-1) - (clipped ** 2).sum(-1))
    np.testing.assert_allclose(rew_c - rew, extra, rtol=1e-4, atol=1e-6)
    rew_2, _, _ = wrapper_run(env, _state(reference, "second"), acts)
    assert np.all(np.abs(rew_2 - rew) > 1e-4)


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_kernel_objective_costs_match_reference(reference, acts, target):
    js, _, ref = reference[target]
    assert_objective_costs_match(Reacher(), port_state(ReacherState, js),
                                 acts, ref[0])


def test_targets_change_the_costs(reference, acts):
    costs = [to_np(kernel_mpc_objective(
        Reacher(), _state(reference, t), H)(None, to_torch(acts)))
        for t in sorted(TARGETS)]
    assert np.all(np.abs(costs[0] - costs[1]) > 1e-3)


def test_nan_lane_goes_nan_alone(reference, acts):
    assert_nan_lane_goes_nan_alone(Reacher(), _state(reference, "second"),
                                   acts)


def test_host_c_build_matches_plain(reference, acts):
    """The action-and-constants body as host C, a NaN lane included."""
    s = _state(reference, "second")
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[4, 0] = np.nan
    qd0 = np.tile(to_np(s.physics.qvel), (N, 1))
    assert_host_c_matches_plain(Reacher(), s, acts, q0, qd0)


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_routed_split_build_matches_the_pallas_kernel(reference, acts,
                                                      target):
    """reacher routes to the split layout with its chain of two links cut
    in two: that body built as host C against JAX's kernel body on the
    same numpy inputs, at each target, within the rollout tolerances."""
    from test_torch_warp_layout import _host_run, _needs_cc
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    _needs_cc()
    env, (js, _, ref) = Reacher(), reference[target]
    s = port_state(ReacherState, js)
    assert (rk.kernel_layout(env), rk.split_partition(env)) == (
        "split", "chain")
    run = rk.load_host_split_rollout(rk.generate_split_header(
        *rk.body_args(env, s), partition=rk.split_partition(env)))
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    qd0 = np.tile(to_np(s.physics.qvel), (N, 1))
    assert_rollout_close(_host_run(run, env, s, q0, qd0, acts), ref)


def test_observe_matches_reference(reference):
    for name in TARGETS:
        js = reference[name][0]
        np.testing.assert_allclose(
            to_np(Reacher().observe(port_state(ReacherState, js))),
            np.asarray(JaxReacher().observe(js)), rtol=1e-6, atol=1e-7)
    assert not hasattr(Reacher(), "success")
    assert not hasattr(JaxReacher(), "success")


def test_runner_runs_reacher_on_cpu():
    run_on_cpu(["Mppi", "reacher", "WhiteNoiseIid", "--alpha", "5"], 2,
               success_test=False)
