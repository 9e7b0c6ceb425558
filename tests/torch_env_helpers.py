"""Shared pieces of the per-env comparison tests of the torch port
(tests/test_torch_{pen,relocate,cheetah}.py).

The JAX reference is ``ppi_tpu.envs.base.batch_rollout`` (the scan path
that tests/test_pallas_rollout.py holds the Pallas kernel to), jitted once
per env; the env's state is a traced argument, so each further goal or
start reuses the compiled program. The port's state is the JAX state
carried across as numpy (``convert.env_state_from_numpy``).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import to_np, to_torch
from ppi_tpu.envs.base import batch_rollout as jax_batch_rollout
from ppi_tpu_torch.convert import env_state_from_numpy
from ppi_tpu_torch.envs.physics.engine import MODEL_FIELDS
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    body_args, env_rollout, generate_env_header, kernel_operands,
    load_host_rollout, plain_rollout)

# tests/test_torch_rollout.py's tolerances: rewards and velocities 1e-5
# relative and absolute, positions 1e-6 absolute
REW_TOL = dict(rtol=1e-5, atol=1e-5)
Q_TOL = dict(rtol=1e-5, atol=1e-6)


def jax_rollout_fn(jenv):
    """``run(jax state, actions (N,H,d_a)) -> (rewards, qf, qdf)`` as numpy,
    one jit of the JAX batch_rollout."""
    fn = jax.jit(lambda s, a: jax_batch_rollout(jenv, s, a))

    def run(jstate, acts):
        final, rew = fn(jstate, jnp.asarray(acts))
        return (np.asarray(rew), np.asarray(final.physics.qpos),
                np.asarray(final.physics.qvel))

    return run


def state_fields(jstate) -> dict:
    """A JAX env state's fields as numpy, physics flattened to qpos/qvel."""
    out = {}
    for k in jstate.__dataclass_fields__:
        v = getattr(jstate, k)
        if k == "physics":
            out["qpos"], out["qvel"] = np.asarray(v.qpos), np.asarray(v.qvel)
        else:
            out[k] = np.asarray(v)
    return out


def port_state(state_cls, jstate):
    return env_state_from_numpy(state_cls, state_fields(jstate), "cpu")


def wrapper_run(env, state, acts, q0=None, qd0=None):
    """The rollout wrapper's CPU path (the plain version) from ``state``:
    (rewards, qf, qdf) as numpy."""
    n, horizon = acts.shape[0], acts.shape[1]
    consts, _, dyn = kernel_operands(env, state)
    run = env_rollout(env, state, horizon)
    q0 = state.physics.qpos.expand(n, -1) if q0 is None else to_torch(q0)
    qd0 = state.physics.qvel.expand(n, -1) if qd0 is None else to_torch(qd0)
    return tuple(to_np(x) for x in run(q0, qd0, to_torch(acts),
                                       consts=consts, dyn=dyn))


def assert_rollout_close(got, ref):
    rew, qf, qdf = got
    np.testing.assert_allclose(rew, ref[0], **REW_TOL)
    np.testing.assert_allclose(qf, ref[1], **Q_TOL)
    np.testing.assert_allclose(qdf, ref[2], **REW_TOL)


def assert_model_equals_reference(jenv, env):
    for field in MODEL_FIELDS:
        ref = np.asarray(getattr(jenv._model, field))
        got = getattr(env._model, field)
        assert got.dtype == ref.dtype and got.shape == ref.shape, field
        np.testing.assert_array_equal(got, ref, err_msg=field)
    assert env._model.parents == jenv._model.parents
    assert env._model.joint_types == jenv._model.joint_types


def assert_host_c_matches_plain(env, state, acts, q0, qd0):
    """The skeleton plus the env's generated body, built as host C, against
    the plain version on the same lanes (NaN lanes included)."""
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    n, h = acts.shape[0], acts.shape[1]
    consts, _, _ = kernel_operands(env, state)
    args = body_args(env, state)
    rew_p, qf_p, qdf_p = (to_np(x) for x in plain_rollout(
        env._model, env.dt, env.substeps, env.scalar_torque,
        env.scalar_reward, to_torch(q0), to_torch(qd0), to_torch(acts),
        consts=consts, reward_takes_action=args[-1]))
    fn = load_host_rollout(generate_env_header(*args))
    nq = q0.shape[1]
    q0_t, qd0_t = np.ascontiguousarray(q0.T), np.ascontiguousarray(qd0.T)
    act_t = np.ascontiguousarray(acts.transpose(1, 2, 0))
    c = None if consts is None else np.ascontiguousarray(to_np(consts))
    rew = np.empty((h, n), np.float32)
    qf, qdf = np.empty((nq, n), np.float32), np.empty((nq, n), np.float32)
    ptr = lambda a: None if a is None else a.ctypes.data
    assert fn(ptr(q0_t), ptr(qd0_t), ptr(act_t), None, ptr(c), ptr(rew),
              ptr(qf), ptr(qdf), n, h) == 0
    np.testing.assert_allclose(rew.T, rew_p, **REW_TOL)
    np.testing.assert_allclose(qf.T, qf_p, **REW_TOL)
    np.testing.assert_allclose(qdf.T, qdf_p, **REW_TOL)
    assert np.array_equal(np.isnan(rew.T), np.isnan(rew_p))
