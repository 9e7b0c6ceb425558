"""finger~spin: the port's env and rollout against the JAX package.

Two starts: "reset", drawn by the JAX reset (key 0), and "contact", the
fingertip 5 mm into the spinner's pad (finger at (-0.25, -0.5), spinner at
0, all at rest), so the sphere-segment contact acts from the first substep
and spins the paddle. The reward takes the raw action and clips it; the
actions (scale 5) reach past the +-4 torque box in about two cells of five.
Tolerances are tests/test_torch_rollout.py's (tests/torch_env_helpers.py).
"""

import math

import jax
import numpy as np
import pytest

from torch_env_helpers import (
    assert_host_c_matches_plain, assert_kernel_step_is_the_eager_step,
    assert_model_equals_reference, assert_nan_lane_goes_nan_alone,
    assert_objective_costs_match, assert_reward_clips_the_raw_action,
    assert_rollout_close, assert_uniform, jax_rollout_fn, pinned_jax_state,
    port_state, resets, run_on_cpu, wrapper_run)
from torch_helpers import to_np
from ppi_tpu.envs.finger import FingerSpin as JaxFingerSpin
from ppi_tpu_torch.envs.finger import SPINNER, FingerSpin, FingerState

N, H = 8, 6
CONTACT_Q = (-0.25, -0.5, 0.0)


@pytest.fixture(scope="module")
def acts():
    return (5.0 * np.random.default_rng(0).standard_normal(
        (N, H, 2))).astype(np.float32)


@pytest.fixture(scope="module")
def reference(acts):
    """{start: (JAX state, (rewards, qf, qdf))}, one JAX compile."""
    jenv = JaxFingerSpin()
    run = jax_rollout_fn(jenv)
    js = jenv.reset(jax.random.key(0))
    out = {}
    for name, state in (("reset", js),
                        ("contact", pinned_jax_state(js, qpos=CONTACT_Q))):
        out[name] = (state, run(state, acts))
    return out


def _state(reference, name):
    return port_state(FingerState, reference[name][0])


def test_model_matches_reference():
    assert_model_equals_reference(JaxFingerSpin(), FingerSpin())


@pytest.mark.parametrize("full_range", [False, True])
def test_reset_distribution(full_range):
    """The finger joints at the engage pose + U(-0.2, 0.2) (or uniform
    over their limits), the spinner U(-pi, pi), at rest."""
    env = FingerSpin(full_range_init=full_range)
    q = np.stack([to_np(s.physics.qpos) for s in resets(env)])
    if full_range:
        lim = np.asarray(JaxFingerSpin()._model.q_limit[:2])
        assert_uniform(q[:, :2], lim[:, 0], lim[:, 1])
    else:
        assert_uniform(q[:, :2], np.array([-0.4, -0.7]),
                       np.array([0.0, -0.3]))
    assert_uniform(q[:, 2:], -math.pi, math.pi)
    fixed = FingerSpin(fixed_init=True).reset(None, "cpu")
    np.testing.assert_array_equal(to_np(fixed.physics.qpos), np.asarray(
        JaxFingerSpin(fixed_init=True).reset(jax.random.key(0)).physics.qpos))
    assert float(fixed.physics.qvel.abs().max()) == 0.0


@pytest.mark.parametrize("start", ["reset", "contact"])
def test_plain_rollout_matches_reference(reference, acts, start):
    js, ref = reference[start]
    assert_rollout_close(wrapper_run(FingerSpin(), _state(reference, start),
                                     acts), ref)


def test_the_tip_spins_the_paddle(reference):
    """Only the contact moves the free paddle: it turns in every lane from
    the contact start."""
    qf = reference["contact"][1][1]
    assert np.all(np.abs(qf[:, SPINNER]) > 1e-3)


def test_reward_clips_the_raw_action(reference, acts):
    assert_reward_clips_the_raw_action(FingerSpin(),
                                       _state(reference, "contact"), acts,
                                       4.0)


def test_step_is_the_kernel_step(reference, acts):
    s = _state(reference, "contact")
    assert_kernel_step_is_the_eager_step(FingerSpin(), s,
                                         to_np(s.physics.qpos), acts[0, 0])


@pytest.mark.parametrize("start", ["reset", "contact"])
def test_kernel_objective_costs_match_reference(reference, acts, start):
    assert_objective_costs_match(FingerSpin(), _state(reference, start),
                                 acts, reference[start][1][0])


def test_nan_lane_goes_nan_alone(reference, acts):
    assert_nan_lane_goes_nan_alone(FingerSpin(),
                                   _state(reference, "contact"), acts)


def test_host_c_build_matches_plain(reference, acts):
    """The sphere-segment contact body as host C, a NaN lane included."""
    s = _state(reference, "contact")
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[5, 2] = np.nan
    qd0 = np.zeros_like(q0)
    assert_host_c_matches_plain(FingerSpin(), s, acts, q0, qd0)


@pytest.mark.parametrize("start", ["reset", "contact"])
def test_routed_split_build_matches_the_pallas_kernel(reference, acts,
                                                      start):
    """finger~spin routes to the split layout with its three bodies cut
    into a chain of segments: that body built as host C against JAX's
    kernel body on the same numpy inputs, from each start, within the
    rollout tolerances."""
    from test_torch_warp_layout import _host_run, _needs_cc
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    _needs_cc()
    env, s = FingerSpin(), _state(reference, start)
    assert (rk.kernel_layout(env), rk.split_partition(env)) == (
        "split", "chain")
    run = rk.load_host_split_rollout(rk.generate_split_header(
        *rk.body_args(env, s), partition=rk.split_partition(env)))
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    qd0 = np.tile(to_np(s.physics.qvel), (N, 1))
    assert_rollout_close(_host_run(run, env, s, q0, qd0, acts),
                         reference[start][1])


def test_observe_matches_reference(reference):
    for name in ("reset", "contact"):
        js = reference[name][0]
        np.testing.assert_allclose(
            to_np(FingerSpin().observe(port_state(FingerState, js))),
            np.asarray(JaxFingerSpin().observe(js)), rtol=1e-6, atol=1e-7)
    assert not hasattr(FingerSpin(), "success")


def test_runner_runs_finger_spin_on_cpu():
    run_on_cpu(["Mppi", "finger~spin", "ColouredNoise", "--beta", "2",
                "--alpha", "10", "--anneal", "0.9"], 2, success_test=False)
