"""The noise-prior family and its FFT noise against the JAX package.

Both packages get the same numpy inputs, and the coloured noise the same
normal draws of its spectrum: JAX's own ``sr``/``si`` for a key go into the
port's synthesis. Tolerances: 1e-5 (absolute and relative) on f32 values
that go through a few ops; the FFT noise 2e-5 absolute, since pocketfft and
XLA's FFT sum in other orders and the output is of order one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
import ppi_tpu.policies.noise as jax_noise
import ppi_tpu_torch.policies.noise as noise
from ppi_tpu.algorithms import make_solver as jax_make_solver
from ppi_tpu.algorithms.base import _one_iteration as jax_one_iteration
from ppi_tpu.ops.fftnoise import powerlaw_psd_gaussian as jax_powerlaw
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu.samplers import SamplerKind as JaxSamplerKind
from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.algorithms.base import _one_iteration
from ppi_tpu_torch.convert import noise_state_from_numpy
from ppi_tpu_torch.ops.fftnoise import (
    powerlaw_from_normals, powerlaw_psd_gaussian)
from ppi_tpu_torch.policies import (
    POLICY_NAMES, design_moments, make_policy)
from ppi_tpu_torch.policies.kernels import time_remap_matrix
from ppi_tpu_torch.samplers import SamplerKind

H, D, N = 7, 3, 16
DT = 0.05
LOW = np.array([-1.0, -2.0, -0.5], np.float32)
HIGH = np.array([1.0, 1.0, 0.5], np.float32)
FAMILIES = ["WhiteNoiseIid", "ColouredNoise", "SmoothExplorationNoise",
            "SmoothActionNoise"]
BETA = {"WhiteNoiseIid": 2.0, "ColouredNoise": 2.0,
        "SmoothExplorationNoise": 0.4, "SmoothActionNoise": 0.6}
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_draws(key, shape):
    """The two normal draws JAX's powerlaw_psd_gaussian takes for ``key``."""
    k_re, k_im = jax.random.split(key)
    fshape = shape[:-1] + (shape[-1] // 2 + 1,)
    return (np.asarray(jax.random.normal(k_re, fshape)),
            np.asarray(jax.random.normal(k_im, fshape)))


def _pair(name, sampler="MonteCarlo", max_particles=1):
    """(JAX family, JAX state, port family, port state) from the same
    design moments; the port's state is the JAX state carried across."""
    t = DT * np.arange(H, dtype=np.float32)
    jm, jci, jco = jax_design_moments(jnp.asarray(LOW), jnp.asarray(HIGH),
                                      1000.0)
    jfam, jstate = jax_make_policy(
        name, jnp.asarray(t), D, jm, jci, jco, sampler=sampler,
        beta=BETA[name], lower=jnp.asarray(LOW), upper=jnp.asarray(HIGH),
        max_particles=max_particles)
    m, ci, co = design_moments(to_torch(LOW), to_torch(HIGH), 1000.0)
    fam, state = make_policy(name, to_torch(t), D, m, ci, co,
                             sampler=sampler, beta=BETA[name],
                             lower=to_torch(LOW), upper=to_torch(HIGH),
                             max_particles=max_particles, device="cpu")
    return jfam, jstate, fam, state


def _fields(jstate):
    return {k: np.asarray(getattr(jstate, k))
            for k in jstate.__dataclass_fields__}


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    params = np.clip(rng.standard_normal((N, H, D)), LOW, HIGH).astype(
        np.float32)
    log_w = (-3.0 * rng.random(N)).astype(np.float32)
    log_w[4] = -np.inf  # a masked lane
    return params, log_w


@pytest.mark.parametrize("n, beta", [(6, 2.0), (7, 2.0), (20, 1.0),
                                     (9, 0.0)])
def test_powerlaw_synthesis_from_jax_draws(n, beta):
    key = jax.random.key(n)
    shape = (5, 2, n)
    ref = np.asarray(jax_powerlaw(key, beta, shape))
    sr, si = _jax_draws(key, shape)
    out = powerlaw_from_normals(to_torch(sr), to_torch(si), beta, n)
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(to_np(out), ref, atol=2e-5)


def test_powerlaw_draws_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    out = powerlaw_psd_gaussian(gen, 2.0, (40, 16))
    again = powerlaw_psd_gaussian(torch.Generator().manual_seed(3), 2.0,
                                  (40, 16))
    assert out.shape == (40, 16) and torch.equal(out, again)
    assert powerlaw_psd_gaussian(gen, 2.0, (3, 1)).shape == (3, 1)


@pytest.mark.parametrize("beta", [0.3, 0.8])
def test_ema_smooth_matches_a_step_loop_and_the_reference(beta):
    x = np.random.default_rng(1).standard_normal((4, H, D)).astype(
        np.float32)
    out = to_np(noise.ema_smooth(to_torch(x), beta))
    y = x[:, 0]
    loop = [y]
    for t in range(1, H):
        y = (1.0 - beta) * y + beta * x[:, t]
        loop.append(y)
    np.testing.assert_allclose(out, np.stack(loop, 1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        out, np.asarray(jax_noise.ema_smooth(jnp.asarray(x), beta)), **TOL)


def test_time_remap_matrix_matches_reference():
    t_old = DT * np.arange(H, dtype=np.float32)
    t_new = t_old + np.float32(DT)
    np.testing.assert_array_equal(
        to_np(time_remap_matrix(to_torch(t_new), to_torch(t_old))),
        np.asarray(jax_noise.time_remap_matrix(jnp.asarray(t_new),
                                               jnp.asarray(t_old))))


@pytest.mark.parametrize("name", FAMILIES)
def test_init_matches_reference(name):
    _, jstate, fam, state = _pair(name)
    assert fam.name == name and fam.dim_sample == H * D
    for k, v in _fields(jstate).items():
        np.testing.assert_allclose(to_np(getattr(state, k)), v, **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_weighted_update_matches_reference(name):
    jfam, jstate, fam, _ = _pair(name)
    state = noise_state_from_numpy(_fields(jstate), "cpu")
    params, log_w = _batch()
    jnew, jess, _ = jfam.weighted_update(jstate, jnp.asarray(log_w),
                                         jnp.asarray(params))
    new, ess, kl = fam.weighted_update(state, to_torch(log_w),
                                       to_torch(params))
    for k in ("mean", "std", "map_sequence"):
        np.testing.assert_allclose(to_np(getattr(new, k)),
                                   np.asarray(getattr(jnew, k)), **TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(to_np(new.map_sequence),
                                  params[np.argmax(log_w)])
    np.testing.assert_allclose(float(ess), float(jess), rtol=1e-5)
    assert float(kl) == 0.0


def test_update_without_covariance_keeps_the_std():
    jfam, jstate, fam, _ = _pair("ColouredNoise")
    state = noise_state_from_numpy(_fields(jstate), "cpu")
    params, log_w = _batch(1)
    new, _, _ = fam.weighted_update(state, to_torch(log_w), to_torch(params),
                                    update_covariance=False)
    jnew, _, _ = jfam.weighted_update(jstate, jnp.asarray(log_w),
                                      jnp.asarray(params),
                                      update_covariance=False)
    assert torch.equal(new.std, state.std)
    np.testing.assert_allclose(to_np(new.mean), np.asarray(jnew.mean), **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_update_timesteps_shift_and_anneal_match_reference(name):
    """A fitted posterior shifted one step on, annealed by 0.9."""
    jfam, jstate, fam, _ = _pair(name)
    params, log_w = _batch(2)
    jstate, _, _ = jfam.weighted_update(jstate, jnp.asarray(log_w),
                                        jnp.asarray(params))
    state = noise_state_from_numpy(_fields(jstate), "cpu")
    t_new = np.asarray(jstate.t) + np.float32(DT)
    jshift = jfam.update_timesteps(jstate, jnp.asarray(t_new), 0.9)
    shift = fam.update_timesteps(state, to_torch(t_new), 0.9, same=False)
    for k in ("t", "mean", "std"):
        np.testing.assert_allclose(to_np(getattr(shift, k)),
                                   np.asarray(getattr(jshift, k)), **TOL,
                                   err_msg=k)
    # the newly exposed last step returns to the prior's std
    np.testing.assert_allclose(to_np(shift.std[-1]), to_np(state.sigma_row),
                               rtol=1e-6)
    # on the same window only the anneal acts, whatever the agent's hint
    same = fam.update_timesteps(state, state.t, 0.9, same=True)
    jsame = jfam.update_timesteps(jstate, jstate.t, 0.9)
    np.testing.assert_allclose(to_np(same.std), np.asarray(jsame.std), **TOL)


def test_particles_shift_with_the_window():
    jfam, jstate, fam, state = _pair(
        "ColouredNoise", sampler="Particles", max_particles=3)
    assert fam.sampler == SamplerKind.PARTICLES
    elites = np.random.default_rng(3).standard_normal((2, H, D)).astype(
        np.float32)
    jstate = jfam.set_particles(jstate, jnp.asarray(elites), 2)
    state = fam.set_particles(state, to_torch(elites), 2)
    assert int(state.n_particles) == 2
    t_new = np.asarray(jstate.t) + np.float32(DT)
    jshift = jfam.update_timesteps(jstate, jnp.asarray(t_new), 0.9)
    shift = fam.update_timesteps(state, to_torch(t_new), 0.9)
    np.testing.assert_array_equal(to_np(shift.particles),
                                  np.asarray(jshift.particles))


@pytest.mark.parametrize("name", FAMILIES)
def test_entropy_and_predict_mean_match_reference(name):
    jfam, jstate, fam, _ = _pair(name)
    params, log_w = _batch(4)
    jstate, _, _ = jfam.weighted_update(jstate, jnp.asarray(log_w),
                                        jnp.asarray(params))
    state = noise_state_from_numpy(_fields(jstate), "cpu")
    np.testing.assert_allclose(float(fam.entropy(state)),
                               float(jfam.entropy(jstate)), rtol=1e-5)
    np.testing.assert_allclose(to_np(fam.predict_mean(state)),
                               np.asarray(jfam.predict_mean(jstate)), **TOL)
    np.testing.assert_allclose(to_np(fam.reset_covariance(state).std),
                               np.asarray(jfam.reset_covariance(jstate).std),
                               **TOL)


@pytest.mark.parametrize("name", ["WhiteNoiseIid", "SmoothActionNoise"])
def test_synthesis_from_the_same_base_draws(name):
    jfam, jstate, fam, _ = _pair(name)
    params, log_w = _batch(5)
    jstate, _, _ = jfam.weighted_update(jstate, jnp.asarray(log_w),
                                        jnp.asarray(params))
    state = noise_state_from_numpy(_fields(jstate), "cpu")
    z = 3.0 * np.random.default_rng(6).standard_normal((N, H, D)).astype(
        np.float32)
    xs = fam.synth(state, to_torch(z))
    np.testing.assert_allclose(to_np(xs), np.asarray(jfam.synth(
        jstate, jnp.asarray(z))), **TOL)
    assert bool((xs >= to_torch(LOW)).all() and (xs <= to_torch(HIGH)).all())


def test_sampling_shapes_and_generator():
    for name in FAMILIES:
        _, _, fam, state = _pair(name)
        xs, params = fam.sample(state, torch.Generator().manual_seed(0), N)
        again, _ = fam.sample(state, torch.Generator().manual_seed(0), N)
        assert xs.shape == (N, H, D) and params is xs
        assert torch.equal(xs, again) and bool(torch.isfinite(xs).all())


def test_one_mppi_iteration_from_the_same_draws():
    """One Mppi iteration with ColouredNoise on a quadratic objective; both
    packages synthesize from JAX's draws for one fixed key."""
    key = jax.random.key(11)
    shape = (N, D, H)
    sr, si = _jax_draws(key, shape)
    target = np.linspace(-0.4, 0.4, H * D, dtype=np.float32).reshape(H, D)

    jfam, jstate, fam, _ = _pair("ColouredNoise")
    state = noise_state_from_numpy(_fields(jstate), "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_noise, "powerlaw_psd_gaussian",
                   lambda k, beta, shp: jax_powerlaw(key, beta, shp))
        mp.setattr(noise, "powerlaw_psd_gaussian",
                   lambda gen, beta, shp, device: powerlaw_from_normals(
                       to_torch(sr), to_torch(si), beta, shp[-1]))
        jstep = jax_one_iteration(
            jax_make_solver("Mppi", alpha=10.0), jfam,
            lambda k, a: jnp.sum((a - jnp.asarray(target)) ** 2, (1, 2)), N)
        jnew, (jstats, jacts, jcosts) = jstep(jstate, jax.random.key(0))
        step = _one_iteration(
            make_solver("Mppi", alpha=10.0), fam,
            lambda g, a: torch.sum((a - to_torch(target)) ** 2, (1, 2)), N)
        new, (stats, acts, costs) = step(state, torch.Generator())
    np.testing.assert_allclose(to_np(acts), np.asarray(jacts), **TOL)
    np.testing.assert_allclose(to_np(costs), np.asarray(jcosts), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(new.mean), np.asarray(jnew.mean),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(new.map_sequence),
                               np.asarray(jnew.map_sequence), **TOL)
    np.testing.assert_allclose(to_np(new.std), np.asarray(jnew.std), **TOL)
    for k in ("ess", "ent"):
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-4, err_msg=k)


def test_registry_and_beta():
    assert set(FAMILIES) <= set(POLICY_NAMES)
    fam, _ = _pair("ColouredNoise")[2:]
    assert fam.beta == 2.0
    fam, _ = _pair("SmoothExplorationNoise")[2:]
    assert fam.beta == 0.4
    with pytest.raises(ValueError, match="beta"):
        make_policy("SmoothActionNoise", torch.zeros(H), D, torch.zeros(D),
                    torch.ones(1), torch.eye(D), beta=2.0, device="cpu")
    assert JaxSamplerKind.PARTICLES.value == SamplerKind.PARTICLES.value
