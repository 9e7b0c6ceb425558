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
import torch

from torch_env_helpers import assert_steps_through_env_step
from torch_helpers import (
    CLAMP_AT, DOOR_Q, door_clamp, door_q0, to_np, to_torch)
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


def test_real_step_goes_through_env_step(inputs):
    """``step`` is ``rollout_kernel.env_step``: one launch of the kernel
    on a CUDA state; on the CPU the eager step that the batch rollout above
    holds to the JAX env's step."""
    door = Door()
    s0 = door.reset(None, "cpu", frame=SAMPLED_FRAME)
    assert_steps_through_env_step(door, s0, door_q0(1)[0], inputs[0][5, 0])


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
    """Variants (b) and (c) are ported: an identity projection changes
    nothing, reward constants and action rewards reach the reward, and
    missing or misshapen constants raise."""
    door = Door()
    q0 = to_torch(door_q0(3))
    acts = to_torch(np.full((3, H, 4), 0.3, np.float32))
    runs = [make_rollout(door._model, door.dt, door.substeps, H, 4,
                         door.scalar_torque, door.scalar_reward,
                         project_fn=project, dyn_body=DOOR)
            for project in (None, lambda m, q_prev, q, qd: (q, qd))]
    plain, same = (run(q0, q0 * 0.0, acts, dyn=to_torch(FRAME))
                   for run in runs)
    assert all(torch.equal(a, b) for a, b in zip(plain, same))
    run = make_rollout(door._model, door.dt, door.substeps, H, 4,
                       door.scalar_torque,
                       lambda m, q, qd, act, consts: consts[0] * act[0],
                       n_consts=2, reward_takes_action=True, dyn_body=DOOR)
    acts = to_torch(np.ones((3, H, 4), np.float32))
    rew, _, _ = run(q0, q0 * 0.0, acts, consts=to_torch([2.5, 0.0]),
                    dyn=to_torch(FRAME))
    np.testing.assert_array_equal(to_np(rew), np.full((3, H), 2.5))
    with pytest.raises(ValueError, match="consts"):
        run(q0, q0 * 0.0, acts, dyn=to_torch(FRAME))
    with pytest.raises(ValueError, match="consts"):
        run(q0, q0 * 0.0, acts, consts=to_torch([1.0, 2.0, 3.0]),
            dyn=to_torch(FRAME))


# ---- variant (c): the per-step projection against the Pallas kernel -------

def _jax_door_clamp(m, q_prev, q, qd):
    """``torch_helpers.door_clamp`` in jnp, for the Pallas kernel."""
    del m
    q, qd = list(q), list(qd)
    hit = (q[DOOR_Q] > CLAMP_AT) & (q_prev[DOOR_Q] < CLAMP_AT + 1e-3)
    qd[DOOR_Q] = jnp.where(hit, jnp.minimum(qd[DOOR_Q], 0.0), qd[DOOR_Q])
    q[DOOR_Q] = jnp.where(hit, CLAMP_AT, q[DOOR_Q])
    return tuple(q), tuple(qd)


@pytest.fixture(scope="module")
def clamp_inputs():
    """Every door opening at 2 rad/s: lanes 0-3 from closed (the clamp
    fires), lanes 4-7 from 0.05 rad, past the clamp's reach; the fixed
    nominal frame, so the kernels take no dyn row."""
    rng = np.random.default_rng(5)
    n = 8
    q0 = door_q0(n)
    q0[4:, DOOR_Q] = 0.05
    qd0 = np.zeros_like(q0)
    qd0[:, DOOR_Q] = 2.0
    acts = (q0[:, None, :4] + 0.4 * rng.standard_normal((n, H, 4))).astype(
        np.float32)
    return acts, q0, qd0


def test_projection_matches_pallas(clamp_inputs):
    """The port's plain rollout with ``project_fn`` against the JAX
    package's Pallas kernel with the same projection (interpret mode):
    tests/test_door_hand.py's project-hook test, with a clamp that reads
    the pre-step coordinates."""
    acts, q0, qd0 = clamp_inputs
    jdoor, door = JaxDoor(fixed_scene=True), Door(fixed_scene=True)
    ref = jax.jit(make_pallas_rollout(
        jdoor._model, jdoor.dt, jdoor.substeps, H, 4, jdoor.scalar_torque,
        jdoor.scalar_reward, project_fn=_jax_door_clamp, block=128,
        interpret=True))(jnp.asarray(q0), jnp.asarray(qd0),
                         jnp.asarray(acts))
    runs = [make_rollout(door._model, door.dt, door.substeps, H, 4,
                         door.scalar_torque, door.scalar_reward,
                         project_fn=project)
            for project in (door_clamp, None)]
    (rew, qf, qdf), (_, qf_free, _) = (
        tuple(to_np(x) for x in run(to_torch(q0), to_torch(qd0),
                                    to_torch(acts))) for run in runs)
    np.testing.assert_allclose(rew, np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(qf, np.asarray(ref[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(qdf, np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-5)
    # the clamp held the doors that started closed, which open without it,
    # and let the others pass
    assert np.all(qf[:4, DOOR_Q] <= CLAMP_AT)
    assert np.all(qf_free[:4, DOOR_Q] > CLAMP_AT + 0.02)
    np.testing.assert_array_equal(qf[4:], qf_free[4:])
