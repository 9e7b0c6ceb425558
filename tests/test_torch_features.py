"""The port's feature priors (RBF, quadrature RFF) and the matrix-normal
divergences against ``ppi_tpu.policies.features`` / ``ppi_tpu.ops``.

Tolerance: 1e-5 relative, normwise (atol = 1e-5 x max |reference|). The
feature matrices and the weight-space moments are well conditioned (the
weight prior is 1000 I), so torch and XLA agree to a few f32 ulps; the
RFF derivative features scale by frequencies up to ~50, which the
normwise bound absorbs. Cholesky factors are compared through L L^T.
``condition`` inverts the prior covariance and then the posterior
precision, which costs cond(f^T f + cov0^-1) ~ 1e3 in relative accuracy:
its mean and covariance are held to 1e-3, normwise, against a float64
evaluation of the same update too.
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
from ppi_tpu import ops as jax_ops
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch import ops
from ppi_tpu_torch.convert import feature_state_from_numpy
from ppi_tpu_torch.policies import design_moments, make_policy

H, D, N, DT = 8, 4, 48, 0.02
RTOL = 1e-5
LOW = np.array([-1.5, -1.2, -2.0, -2.0], np.float32)
HIGH = -LOW

CONFIGS = {
    "rff": dict(name="RffFeatures", order=4, lengthscale=0.15),
    "rff_bias_deriv": dict(name="RffFeatures", order=3, lengthscale=0.15,
                           add_bias=True, use_derivatives=True),
    "rbf": dict(name="RbfFeatures", n_features=6, lengthscale=0.05),
    "rbf_bias_deriv": dict(name="RbfFeatures", n_features=5,
                           lengthscale=0.05, add_bias=True,
                           use_derivatives=True),
}


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def policies(request):
    cfg = dict(CONFIGS[request.param])
    name = cfg.pop("name")
    t = DT * np.arange(H, dtype=np.float32)
    jm, jci, jco = jax_design_moments(jnp.asarray(LOW), jnp.asarray(HIGH),
                                      1000.0)
    jfam, jstate = jax_make_policy(
        name, jnp.asarray(t), D, jm, jci, jco, lower=jnp.asarray(LOW),
        upper=jnp.asarray(HIGH), track_entropy=True, **cfg)
    m, ci, co = design_moments(to_torch(LOW), to_torch(HIGH), 1000.0)
    fam, state = make_policy(name, to_torch(t), D, m, ci, co,
                             lower=to_torch(LOW), upper=to_torch(HIGH),
                             track_entropy=True, device="cpu", **cfg)
    return jfam, jstate, fam, state


def _z(fam):
    return np.random.default_rng(0).standard_normal(
        (N, fam.dim_features * D)).astype(np.float32)


def _sample_both(policies, monkeypatch):
    jfam, jstate, fam, state = policies
    z = _z(fam)
    monkeypatch.setattr(jax_primitives, "draw_base",
                        lambda kind, key, n, dim: jnp.asarray(z))
    monkeypatch.setattr(primitives, "draw_base",
                        lambda kind, gen, n, dim, device: to_torch(z))
    (jxs, jws), (xs, ws) = (jfam.sample(jstate, jax.random.key(0), N),
                            fam.sample(state, None, N))
    return jxs, jws, xs, ws


def _updated(policies, monkeypatch):
    jfam, jstate, fam, state = policies
    _, jws, _, ws = _sample_both(policies, monkeypatch)
    lw = (3.0 * np.random.default_rng(1).standard_normal(N)).astype(
        np.float32)
    lw[[2, 9]] = -np.inf
    return (jfam.weighted_update(jstate, jnp.asarray(lw), jws),
            fam.weighted_update(state, to_torch(lw), ws))


def test_init_matches_reference(policies):
    jfam, jstate, fam, state = policies
    assert fam.dim_features == jfam.dim_features
    assert fam.dim_sample == jfam.dim_sample
    for f in dataclasses.fields(state):
        _close(getattr(state, f.name), getattr(jstate, f.name))


def test_feat_and_dfeat_match_reference(policies):
    jfam, jstate, fam, state = policies
    t = DT * (np.arange(H, dtype=np.float32) + 3)   # a shifted window
    for got, ref in ((fam.feat, jfam.feat), (fam.dfeat, jfam.dfeat)):
        out = got(state, to_torch(t))
        assert out.shape == (H, fam.dim_features)
        _close(out, ref(jstate, jnp.asarray(t)))


def test_dfeat_is_the_time_derivative_of_feat(policies):
    _, _, fam, state = policies
    t = torch.linspace(0.0, 0.14, H, dtype=torch.float64)
    eps = 1e-6
    num = (fam.feat(state, t + eps) - fam.feat(state, t - eps)) / (2 * eps)
    np.testing.assert_allclose(to_np(fam.dfeat(state, t)), to_np(num),
                               rtol=1e-4, atol=1e-4)


def test_sample_from_the_same_base_draw(policies, monkeypatch):
    jfam, _, fam, _ = policies
    jxs, jws, xs, ws = _sample_both(policies, monkeypatch)
    d_out = 2 * D if fam.use_derivatives else D
    assert xs.shape == (N, H, d_out) and ws.shape == (N, fam.dim_features, D)
    _close(ws, jws)
    _close(xs, jxs)
    head = xs[..., :D]
    assert bool((head >= to_torch(LOW)).all() and (head <= to_torch(HIGH)).all())


def test_weighted_update_matches_reference(policies, monkeypatch):
    (jnew, jess, jkl), (new, ess, kl) = _updated(policies, monkeypatch)
    for f in ("mean", "cov_in"):
        _close(getattr(new, f), getattr(jnew, f))
    _close(new.chol_in @ new.chol_in.T, jnew.cov_in)
    _close(ess, jess)
    assert float(kl) == float(jkl) == 0.0


def test_weighted_update_reverts_mean_when_not_pd(policies, monkeypatch):
    """No live sample: the fitted moments are NaN, the factorization fails,
    and the feature families keep mean and covariance."""
    jfam, jstate, fam, state = policies
    _, jws, _, ws = _sample_both(policies, monkeypatch)
    lw = np.full(N, -np.inf, np.float32)
    jnew, jess, _ = jfam.weighted_update(jstate, jnp.asarray(lw), jws)
    new, ess, _ = fam.weighted_update(state, to_torch(lw), ws)
    np.testing.assert_array_equal(to_np(new.mean), np.asarray(jnew.mean))
    assert torch.equal(new.mean, state.mean)
    assert torch.equal(new.cov_in, state.cov_in)
    assert float(ess) == float(jess) == N


def test_update_timesteps_anneals_toward_the_prior(policies, monkeypatch):
    jfam, _, fam, _ = policies
    (jnew, _, _), (new, _, _) = _updated(policies, monkeypatch)
    t_new = DT * (np.arange(H, dtype=np.float32) + 1)
    jshift = jfam.update_timesteps(jnew, jnp.asarray(t_new), 0.5)
    got = fam.update_timesteps(new, to_torch(t_new), 0.5, same=False)
    _close(got.t, jshift.t)
    _close(got.cov_in, jshift.cov_in)
    _close(got.chol_in @ got.chol_in.T, jshift.cov_in)
    assert torch.equal(got.mean, new.mean)


def test_predictions_match_reference(policies, monkeypatch):
    jfam, _, fam, _ = policies
    (jnew, _, _), (new, _, _) = _updated(policies, monkeypatch)
    for got, ref in zip(fam.predict(new), jfam.predict(jnew)):
        _close(got, ref)
    _close(fam.predict_mean(new), jfam.predict_mean(jnew))
    best = np.random.default_rng(3).standard_normal(
        (fam.dim_features, D)).astype(np.float32)
    _close(fam.map_action_sequence(fam.set_map_sequence(new, to_torch(best))),
           jfam.map_action_sequence(jfam.set_map_sequence(
               jnew, jnp.asarray(best))))
    got = fam.reset_covariance(new)
    assert torch.equal(got.cov_in, new.cov_in_init)
    _close(fam.entropy(new), jfam.entropy(jnew))
    assert float(fam.entropy(new)) != 0.0


def test_condition_matches_reference(policies):
    jfam, jstate, fam, state = policies
    rng = np.random.default_rng(4)
    t = DT * np.array([0.0, 2.0, 5.0], np.float32)
    action = (0.5 * rng.standard_normal((3, D))).astype(np.float32)
    jnew = jfam.condition(jstate, jnp.asarray(t), jnp.asarray(action))
    new = fam.condition(state, to_torch(t), to_torch(action))
    # a float64 evaluation of the same linear-Gaussian update
    f = fam.feat(state, to_torch(t)).double()
    cov0_inv = torch.linalg.inv(state.cov_in.double())
    s_xx = f.T @ f + cov0_inv
    mean64 = torch.linalg.solve(
        s_xx, f.T @ (to_torch(action).double() - state.mean_fn.double()))
    for got in (new.mean, to_torch(jnew.mean)):
        _close(got, mean64, rtol=1e-3)
    for got in (new.cov_in, new.chol_in @ new.chol_in.T,
                to_torch(jnew.cov_in)):
        _close(got, torch.linalg.inv(s_xx), rtol=1e-3)

def test_set_particles_matches_reference(policies):
    jfam, jstate, fam, state = policies
    jfam = dataclasses.replace(jfam, max_particles=3)
    elites = np.random.default_rng(5).standard_normal(
        (2, fam.dim_features, D)).astype(np.float32)
    jnew = jfam.set_particles(jstate, jnp.asarray(elites), 2)
    new = fam.set_particles(state, to_torch(elites), 2)
    _close(new.particles, jnew.particles)
    assert int(new.n_particles) == int(jnew.n_particles) == 1  # buffer of 1


def test_converter_carries_the_state_across(policies):
    _, jstate, _, state = policies
    fields = {f.name: np.asarray(getattr(jstate, f.name))
              for f in dataclasses.fields(state)}
    got = feature_state_from_numpy(fields, "cpu")
    for f in dataclasses.fields(state):
        np.testing.assert_array_equal(to_np(getattr(got, f.name)),
                                      fields[f.name])


# ---- ops/divergences.py -----------------------------------------------------

def _spd(rng, d, scale=1.0):
    a = rng.standard_normal((d, d))
    return (scale * (a @ a.T + d * np.eye(d))).astype(np.float32)


@pytest.mark.parametrize("n,p", [(6, 3), (3, 5)])
def test_matrix_gaussian_kl_and_entropy_match_reference(n, p):
    rng = np.random.default_rng(n)
    m1, m2 = (rng.standard_normal((n, p)).astype(np.float32) for _ in "ab")
    u1, u2, v1, v2 = (_spd(rng, n, 0.3), _spd(rng, n, 2.0), _spd(rng, p),
                      _spd(rng, p, 0.1))
    ref = jax_ops.matrix_gaussian_kl(*(jnp.asarray(x) for x in
                                       (m1, u1, v1, m2, u2, v2)))
    got = ops.matrix_gaussian_kl(*(to_torch(x) for x in
                                   (m1, u1, v1, m2, u2, v2)))
    _close(got, ref)
    assert float(got) > 0.0
    same = ops.matrix_gaussian_kl(*(to_torch(x) for x in
                                    (m1, u1, v1, m1, u1, v1)))
    assert abs(float(same)) < 1e-4
    _close(ops.matrix_normal_entropy(to_torch(u1), to_torch(v1), n, p),
           jax_ops.matrix_normal_entropy(jnp.asarray(u1), jnp.asarray(v1),
                                         n, p))
    # the U/V scale split cancels
    _close(ops.matrix_normal_entropy(to_torch(7.0 * u1), to_torch(v1 / 7.0),
                                     n, p),
           jax_ops.matrix_normal_entropy(jnp.asarray(u1), jnp.asarray(v1),
                                         n, p), rtol=1e-4)


def test_vec_is_column_major():
    from ppi_tpu.ops.divergences import vec as jax_vec
    x = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(to_np(ops.vec(to_torch(x))),
                                  np.asarray(jax_vec(jnp.asarray(x))))
    np.testing.assert_array_equal(to_np(ops.vec(to_torch(x[0]))),
                                  np.asarray(jax_vec(jnp.asarray(x[0]))))


def test_track_kl_reports_the_update_divergence(monkeypatch):
    t = DT * np.arange(H, dtype=np.float32)
    m, ci, co = design_moments(to_torch(LOW), to_torch(HIGH), 1000.0)
    fam, state = make_policy("RffFeatures", to_torch(t), D, m, ci, co,
                             order=3, lengthscale=0.15, device="cpu")
    fam = dataclasses.replace(fam, track_kl=True)
    jm, jci, jco = jax_design_moments(jnp.asarray(LOW), jnp.asarray(HIGH),
                                      1000.0)
    jfam, jstate = jax_make_policy("RffFeatures", jnp.asarray(t), D, jm, jci,
                                   jco, order=3, lengthscale=0.15)
    jfam = dataclasses.replace(jfam, track_kl=True)
    (_, _, jkl), (_, _, kl) = _updated((jfam, jstate, fam, state),
                                       monkeypatch)
    assert float(kl) > 0.0
    _close(kl, jkl, rtol=1e-4)
