"""The port's SE-kernel GP prior against ppi_tpu.policies.kernels.

Tolerance rtol 1e-4, normwise (atol = 1e-4 * max |reference|): the SE gram
at lengthscale 0.08 on a dt = 0.02 grid is ill-conditioned (neighbouring
rows differ by exp(-1/32)), held PD only by the 1e-3 sigma diagonal
(condition number ~6e3 at H = 8), so the f32 Cholesky factors and the
triangular solves of the window shift amplify rounding far past f32
epsilon, and torch (LAPACK) and XLA factor in different orders. After the
window shift the Cholesky factor itself is determined only to about
cond * eps ~ 4e-4 (measured against float64: torch 3.9e-4, XLA 4.2e-5,
while torch's shifted covariance is the closer of the two), so the shifted
factor is checked through L L^T against the reference covariance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
import ppi_tpu.policies.primitives as jax_primitives
import ppi_tpu_torch.policies.primitives as primitives
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.policies import design_moments, make_policy

H, D, N, DT = 8, 4, 64, 0.02
RTOL = 1e-4
LOW = np.array([-1.5, -1.2, -2.0, -2.0], np.float32)
HIGH = -LOW


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30))


def _states_close(got, ref, fields):
    for f in fields:
        _close(getattr(got, f), getattr(ref, f))


@pytest.fixture(scope="module")
def policies():
    t = DT * np.arange(H, dtype=np.float32)
    jm, jci, jco = jax_design_moments(jnp.asarray(LOW), jnp.asarray(HIGH),
                                      1000.0)
    jfam, jstate = jax_make_policy(
        "SquaredExponentialKernel", jnp.asarray(t), D, jm, jci, jco,
        lengthscale=0.08, lower=jnp.asarray(LOW), upper=jnp.asarray(HIGH))
    m, ci, co = design_moments(to_torch(LOW), to_torch(HIGH), 1000.0)
    fam, state = make_policy("SquaredExponentialKernel", to_torch(t), D, m,
                             ci, co, lengthscale=0.08, lower=to_torch(LOW),
                             upper=to_torch(HIGH), device="cpu")
    return jfam, jstate, fam, state


@pytest.fixture(scope="module")
def z():
    return np.random.default_rng(0).standard_normal((N, H * D)).astype(
        np.float32)


def test_init_matches_reference(policies):
    jfam, jstate, fam, state = policies
    assert fam.dim_features == jfam.dim_features == H
    _states_close(state, jstate, [f.name for f in dataclasses.fields(state)])


def test_transform_base_with_the_same_z(policies, z):
    jfam, jstate, fam, state = policies
    zz = z.reshape(N, H, D)
    _close(fam.transform_base(state, to_torch(zz)),
           jfam.transform_base(jstate, jnp.asarray(zz)))


def _sample_both(policies, z, monkeypatch):
    jfam, jstate, fam, state = policies
    monkeypatch.setattr(jax_primitives, "draw_base",
                        lambda kind, key, n, dim: jnp.asarray(z))
    monkeypatch.setattr(primitives, "draw_base",
                        lambda kind, gen, n, dim, device: to_torch(z))
    jxs, _ = jfam.sample(jstate, jax.random.key(0), N)
    xs, params = fam.sample(state, None, N)
    return jxs, xs, params


def test_sample_with_the_same_z(policies, z, monkeypatch):
    jxs, xs, params = _sample_both(policies, z, monkeypatch)
    _close(xs, jxs)
    assert torch.equal(xs, params)
    assert bool((xs >= to_torch(LOW)).all() and (xs <= to_torch(HIGH)).all())


def _updated(policies, z, monkeypatch):
    jfam, jstate, fam, state = policies
    jxs, xs, _ = _sample_both(policies, z, monkeypatch)
    lw = (3.0 * np.random.default_rng(1).standard_normal(N)).astype(
        np.float32)
    lw[[2, 9]] = -np.inf
    jout = jfam.weighted_update(jstate, jnp.asarray(lw), jxs)
    out = fam.weighted_update(state, to_torch(lw), xs)
    return jout, out


def test_weighted_update_matches_reference(policies, z, monkeypatch):
    (jnew, jess, _), (new, ess, kl) = _updated(policies, z, monkeypatch)
    _states_close(new, jnew, ["mean", "cov_in", "chol_in", "map_sequence"])
    _close(ess, jess)
    assert float(kl) == 0.0


@pytest.mark.parametrize("shift", [0, 1, 3])
def test_update_timesteps_matches_reference(policies, z, monkeypatch, shift):
    """anneal 0.5; shift 0 is the unchanged window (a no-op)."""
    jfam, _, fam, _ = policies
    (jnew, _, _), (new, _, _) = _updated(policies, z, monkeypatch)
    t_new = DT * (np.arange(H, dtype=np.float32) + shift)
    jshift = jfam.update_timesteps(jnew, jnp.asarray(t_new), 0.5)
    got = fam.update_timesteps(new, to_torch(t_new), 0.5,
                               same=shift == 0 or None)
    _states_close(got, jshift, ["t", "mean", "cov_in"])
    _close(got.chol_in @ got.chol_in.T, jshift.cov_in)
    assert torch.equal(got.chol_in, torch.tril(got.chol_in))
    if shift == 0:
        assert got.cov_in is new.cov_in


def test_compute_prior_and_predictions(policies, z, monkeypatch):
    jfam, _, fam, _ = policies
    (jnew, _, _), (new, _, _) = _updated(policies, z, monkeypatch)
    t_new = DT * (np.arange(H, dtype=np.float32) + 2)
    _states_close(fam.compute_prior(new, to_torch(t_new)),
                  jfam.compute_prior(jnew, jnp.asarray(t_new)),
                  ["t", "cov_prior", "chol_prior"])
    _close(fam.predict_mean(new), jfam.predict_mean(jnew))
    _close(fam.map_action_sequence(new), jfam.map_action_sequence(jnew))
    _states_close(fam.reset_covariance(new), jfam.reset_covariance(jnew),
                  ["cov_in", "chol_in"])


def test_unported_families_raise():
    """Every name of the JAX registry is ported; a name outside it raises."""
    with pytest.raises(ValueError, match="Unknown policy family"):
        make_policy("Matern72Kernel", torch.zeros(H), D, torch.zeros(D),
                    torch.ones(1), torch.eye(D), device="cpu")
