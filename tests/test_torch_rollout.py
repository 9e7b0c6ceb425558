"""The port's plain rollout against the JAX Pallas kernel and batch_rollout.

The JAX kernel runs in Pallas interpret mode on the CPU, as
tests/test_pallas_rollout.py runs it. Both packages get the same numpy
actions, initial lanes and door frame. Tolerances are those of
tests/test_pallas_rollout.py: rtol/atol 1e-5 for rewards and velocities,
atol 1e-6 for positions. Horizons stay at h <= 4, where the door stays
shut: the reward has +2/+8/+10 steps at door angles 0.2/1.0/1.35, so a
1-ulp state difference at a threshold would move one reward by up to 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import door_q0, to_np, to_torch
from ppi_tpu.envs.base import batch_rollout as jax_batch_rollout
from ppi_tpu.envs.base import mpc_objective as jax_mpc_objective
from ppi_tpu.envs.door import Door as JaxDoor
from ppi_tpu.envs.physics.pallas_rollout import make_pallas_rollout
from ppi_tpu_torch.envs.base import batch_rollout, mpc_objective
from ppi_tpu_torch.envs.door import DOOR, FRAME, Door
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    kernel_mpc_objective, make_rollout, supports_kernel)

N, H = 37, 4          # ragged: not a multiple of any block
NAN_LANE = 5
SAMPLED_FRAME = np.array([0.583, 0.312, 1.061], np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    acts = (0.4 * rng.standard_normal((N, H, 4))).astype(np.float32)
    q0 = door_q0(N)
    q0[NAN_LANE] = np.nan  # a pre-poisoned lane
    return acts, q0, np.zeros_like(q0)


@pytest.fixture(scope="module")
def pallas(inputs):
    """The JAX Pallas kernel (interpret mode) at the nominal and the sampled
    frame: {name: (rewards, qf, qdf)}."""
    acts, q0, qd0 = inputs
    door = JaxDoor()
    run = jax.jit(make_pallas_rollout(
        door._model, door.dt, door.substeps, H, door.action_dim,
        door.scalar_torque, door.scalar_reward, dyn_body=DOOR, block=128,
        interpret=True))
    return {name: tuple(np.asarray(x) for x in run(
                jnp.asarray(q0), jnp.asarray(qd0), jnp.asarray(acts),
                dyn=jnp.asarray(frame)))
            for name, frame in (("nominal", np.asarray(FRAME, np.float32)),
                                ("sampled", SAMPLED_FRAME))}


@pytest.fixture(scope="module")
def port_run():
    door = Door()
    return make_rollout(door._model, door.dt, door.substeps, H,
                        door.action_dim, door.scalar_torque,
                        door.scalar_reward, dyn_body=DOOR)


def _port(port_run, inputs, frame):
    acts, q0, qd0 = inputs
    return tuple(to_np(x) for x in port_run(
        to_torch(q0), to_torch(qd0), to_torch(acts), dyn=to_torch(frame)))


@pytest.mark.parametrize("frame_name", ["nominal", "sampled"])
def test_plain_rewards_match_pallas(pallas, port_run, inputs, frame_name):
    frame = (np.asarray(FRAME, np.float32) if frame_name == "nominal"
             else SAMPLED_FRAME)
    rew, _, _ = _port(port_run, inputs, frame)
    np.testing.assert_allclose(rew, pallas[frame_name][0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("frame_name", ["nominal", "sampled"])
def test_plain_final_state_matches_pallas(pallas, port_run, inputs,
                                          frame_name):
    frame = (np.asarray(FRAME, np.float32) if frame_name == "nominal"
             else SAMPLED_FRAME)
    _, qf, qdf = _port(port_run, inputs, frame)
    np.testing.assert_allclose(qf, pallas[frame_name][1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(qdf, pallas[frame_name][2], rtol=1e-5,
                               atol=1e-5)


def test_divergence_poisons_own_lane_only(pallas, port_run, inputs):
    rew, _, _ = _port(port_run, inputs, np.asarray(FRAME, np.float32))
    assert np.isnan(rew[NAN_LANE]).all()
    assert np.isfinite(np.delete(rew, NAN_LANE, axis=0)).all()
    np.testing.assert_array_equal(np.isnan(rew),
                                  np.isnan(pallas["nominal"][0]))


def test_ragged_batch_keeps_exactly_n_rows(port_run, inputs):
    rew, qf, qdf = _port(port_run, inputs, np.asarray(FRAME, np.float32))
    assert rew.shape == (N, H) and qf.shape == qdf.shape == (N, 6)


@pytest.fixture(scope="module")
def jax_rollouts(inputs):
    """JAX batch_rollout from the door's reset state at both frames."""
    acts, _, _ = inputs
    door = JaxDoor()
    s0 = door.reset(jax.random.key(0))
    fn = jax.jit(lambda s, a: jax_batch_rollout(door, s, a))
    out = {}
    for name, frame in (("nominal", np.asarray(FRAME, np.float32)),
                        ("sampled", SAMPLED_FRAME)):
        final, rew = fn(s0.replace(frame=jnp.asarray(frame)),
                        jnp.asarray(acts))
        out[name] = (np.asarray(rew), np.asarray(final.physics.qpos),
                     np.asarray(final.physics.qvel))
    return out


@pytest.mark.parametrize("frame_name", ["nominal", "sampled"])
def test_batch_rollout_matches_reference(jax_rollouts, inputs, frame_name):
    acts, _, _ = inputs
    frame = (np.asarray(FRAME, np.float32) if frame_name == "nominal"
             else SAMPLED_FRAME)
    door = Door()
    s0 = door.reset(None, "cpu", frame=frame)
    final, rew = batch_rollout(door, s0, to_torch(acts))
    ref_rew, ref_q, ref_qd = jax_rollouts[frame_name]
    np.testing.assert_allclose(to_np(rew), ref_rew, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(final.physics.qpos), ref_q, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(final.physics.qvel), ref_qd, rtol=1e-5,
                               atol=1e-5)
    assert int(final.t) == H


def test_plain_kernel_path_matches_batch_rollout(port_run, inputs):
    """The wrapper's CPU path and the env's eager step agree (both run the
    same scalar program)."""
    acts, _, _ = inputs
    door = Door()
    s0 = door.reset(None, "cpu", frame=SAMPLED_FRAME)
    q0 = door_q0(N)
    rew, qf, _ = _port(port_run, (acts, q0, np.zeros_like(q0)),
                       SAMPLED_FRAME)
    final, rew_b = batch_rollout(door, s0, to_torch(acts))
    np.testing.assert_array_equal(rew, to_np(rew_b))
    np.testing.assert_array_equal(qf, to_np(final.physics.qpos))


def test_objective_applies_horizon_mask(inputs):
    acts, _, _ = inputs
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    jdoor = JaxDoor(fixed_scene=True)
    c_ref = jax.jit(lambda s, a, m: jax_mpc_objective(
        jdoor, s, horizon_mask=m)(None, a))(
            jdoor.reset(jax.random.key(0)), jnp.asarray(acts),
            jnp.asarray(mask))
    door = Door(fixed_scene=True)
    s0 = door.reset(None, "cpu")
    c_kernel = kernel_mpc_objective(door, s0, H, to_torch(mask))(
        None, to_torch(acts))
    c_plain = mpc_objective(door, s0, to_torch(mask))(None, to_torch(acts))
    c_full = kernel_mpc_objective(door, s0, H)(None, to_torch(acts))
    np.testing.assert_allclose(to_np(c_kernel), np.asarray(c_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(c_plain), np.asarray(c_ref),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(to_np(c_full), to_np(c_kernel))


def test_supports_kernel_contract():
    assert supports_kernel(Door())
    assert not supports_kernel(object())


def test_unported_variants_raise():
    """Per-step projections (variant c) are not ported; reward constants
    and action rewards (variant b) are."""
    door = Door()
    with pytest.raises(NotImplementedError, match="queue 2"):
        make_rollout(door._model, door.dt, door.substeps, H, 4,
                     door.scalar_torque, door.scalar_reward,
                     project_fn=lambda m, q_prev, q, qd: (q, qd))
    run = make_rollout(door._model, door.dt, door.substeps, H, 4,
                       door.scalar_torque,
                       lambda m, q, qd, act, consts: consts[0] * act[0],
                       n_consts=2, reward_takes_action=True, dyn_body=DOOR)
    acts = to_torch(np.ones((3, H, 4), np.float32))
    q0 = to_torch(door_q0(3))
    rew, _, _ = run(q0, q0 * 0.0, acts, consts=to_torch([2.5, 0.0]),
                    dyn=to_torch(FRAME))
    np.testing.assert_array_equal(to_np(rew), np.full((3, H), 2.5))
    with pytest.raises(ValueError, match="consts"):
        run(q0, q0 * 0.0, acts, dyn=to_torch(FRAME))
    with pytest.raises(ValueError, match="consts"):
        run(q0, q0 * 0.0, acts, consts=to_torch([1.0, 2.0, 3.0]),
            dyn=to_torch(FRAME))
