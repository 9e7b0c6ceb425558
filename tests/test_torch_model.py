"""The port's door model and state converters against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu.envs.door import Door as JaxDoor
from ppi_tpu.envs.physics.engine_soa import SoaModel as JaxSoaModel
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.convert import kernel_state_from_numpy, model_from_numpy
from ppi_tpu_torch.envs.door import Door
from ppi_tpu_torch.envs.physics.engine import MODEL_FIELDS
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel
from ppi_tpu_torch.policies.kernels import KernelState


@pytest.fixture(scope="module")
def models():
    return JaxDoor()._model, Door()._model


@pytest.mark.parametrize("field", MODEL_FIELDS)
def test_door_model_field_equals_reference(models, field):
    """Every numeric field of the builder's model, value and dtype, exactly."""
    jm, tm = models
    ref = np.asarray(getattr(jm, field))
    got = getattr(tm, field)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_door_topology_equals_reference(models):
    jm, tm = models
    assert tm.parents == jm.parents and tm.joint_types == jm.joint_types
    assert tm.nq == jm.nq == 6


def test_soa_constants_equal_reference(models):
    """The folded Python constants the scalar program reads."""
    jm, tm = models
    js, ts = JaxSoaModel(jm), SoaModel(tm)
    for name in ("offset_pos", "offset_rot", "axis", "mass", "com",
                 "inertia", "damping", "armature", "spring_k", "q_limit",
                 "limit_k", "sphere_pos", "sphere_radius",
                 "pair_sphere_segment", "gravity", "ancestors"):
        assert getattr(ts, name) == getattr(js, name), name
    for name in ("contact_stiffness", "contact_damping", "friction_mu",
                 "friction_vel_k"):
        assert getattr(ts, name) == getattr(js, name), name


def test_model_from_numpy_round_trip(models):
    jm, tm = models
    fields = {f: np.asarray(getattr(jm, f)) for f in MODEL_FIELDS}
    got = model_from_numpy(fields, jm.parents, jm.joint_types)
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(tm, f))
        assert getattr(got, f).dtype == getattr(tm, f).dtype
    assert got.parents == tm.parents and got.joint_types == tm.joint_types
    with pytest.raises(KeyError):
        model_from_numpy({"mass": fields["mass"]}, jm.parents, jm.joint_types)


def test_kernel_state_from_numpy_round_trip():
    env = JaxDoor()
    mean, cov_in, cov_out = jax_design_moments(env.action_low,
                                               env.action_high, 1000.0)
    _, state = jax_make_policy(
        "SquaredExponentialKernel", env.dt * jnp.arange(8), 4, mean, cov_in,
        cov_out, lengthscale=0.08, lower=env.action_low,
        upper=env.action_high)
    fields = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(state)}
    got = kernel_state_from_numpy(fields, "cpu")
    assert isinstance(got, KernelState)
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v)
        assert getattr(got, k).numpy().dtype == v.dtype, k
