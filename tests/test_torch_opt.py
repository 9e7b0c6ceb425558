"""The port's black-box optimization stack against ppi_tpu on the same inputs.

The Gaussian family (the JAX state carried across through convert.py, base
draws fed from numpy), the test functions, each solver's update on one
shared batch, the samplers and a short solve.

Tolerances. Moments: rtol 1e-5 / atol 1e-6 (f32 sums in another order).
Cholesky factors: 1e-4 (torch's and XLA's factorizations round
differently). KLs: 5e-4 relative -- a KL is a difference of two f32
log-determinants plus LU solves, and the posterior's KL after a solver's
update measured 1.4e-4 relative (LBPS, KL 2.13). Temperatures from a grid
zoom: equal, or one final zoom cell apart when the objective is flat at
its minimum (the LBPS near-tie of ROADMAP queue 3 applies to every grid
search); the posterior is then compared at the reference's temperature.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
import ppi_tpu.policies.gaussian as jax_gaussian
import ppi_tpu_torch.policies.gaussian as gaussian
from ppi_tpu.algorithms import make_solver as jax_make_solver
from ppi_tpu.algorithms.base import Batch as JaxBatch
from ppi_tpu.algorithms.base import mask_costs as jax_mask_costs
from ppi_tpu.envs.functions import make_function as jax_make_function
from ppi_tpu.ops.qmc import sobol_normal as jax_sobol_normal
from ppi_tpu.ops.qmc import sobol_uniform as jax_sobol_uniform
from ppi_tpu.samplers import SamplerKind as JaxSamplerKind
from ppi_tpu.samplers import cubature_points as jax_cubature_points
from ppi_tpu.samplers import inject_particles as jax_inject_particles
from ppi_tpu_torch import ops
from ppi_tpu_torch.algorithms import (
    ALGORITHMS, Batch, make_solver, mask_costs)
from ppi_tpu_torch.algorithms.base import minmax_normalize
from ppi_tpu_torch.convert import gaussian_state_from_numpy
from ppi_tpu_torch.envs.functions import FUNCTIONS, make_function
from ppi_tpu_torch.ops.qmc import sobol_points, uniform_to_normal
from ppi_tpu_torch.ops.scalar_opt import ALPHA_LOWER, ALPHA_UPPER
from ppi_tpu_torch.samplers import (
    SamplerKind, cubature_points, draw_base, inject_particles)

D, N = 5, 64
KL_RTOL = 5e-4
# one final zoom cell of the 64 + 2 x 33 log-grid over [1e-5, 5e2]
CELL = np.log(ALPHA_UPPER / ALPHA_LOWER) / 63 * 2 / 32 * 2 / 32


def _prior(d=D, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    sigma = (0.3 * a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)
    return rng.standard_normal(d).astype(np.float32), sigma


def _families(d=D, sampler="MONTE_CARLO", **kw):
    """(JAX family, JAX state, port family, port state) from one prior."""
    mu, sigma = _prior(d)
    jfam = jax_gaussian.Gaussian(dim=d, sampler=JaxSamplerKind[sampler],
                                 **kw)
    jstate = jfam.init(jnp.asarray(mu), jnp.asarray(sigma))
    fam = gaussian.Gaussian(dim=d, sampler=SamplerKind[sampler], **kw)
    state = gaussian_state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(gaussian.GaussianState)}, "cpu")
    return jfam, jstate, fam, state


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _states_close(new, jnew, chol_tol=1e-4):
    _close(new.mu, jnew.mu)
    _close(new.sigma, jnew.sigma)
    _close(new.chol, jnew.chol, rtol=chol_tol, atol=chol_tol)


def _feed_base(monkeypatch, z):
    monkeypatch.setattr(jax_gaussian, "draw_base",
                        lambda kind, key, n, dim: jnp.asarray(z))
    monkeypatch.setattr(gaussian, "draw_base",
                        lambda kind, gen, n, dim, device: to_torch(z))


# ---- the Gaussian family ---------------------------------------------------------

def test_state_carried_across_and_sample(monkeypatch):
    jfam, jstate, fam, state = _families()
    z = np.random.default_rng(1).standard_normal((N, D)).astype(np.float32)
    _feed_base(monkeypatch, z)
    jxs, jparams = jfam.sample(jstate, jax.random.key(0), N)
    xs, params = fam.sample(state, None, N)
    _close(xs, jxs)
    assert xs is params
    _close(fam.entropy(state), jfam.entropy(jstate), rtol=1e-6)
    _close(fam.predict_mean(state), jfam.predict_mean(jstate))


def _weighted_case(case):
    rng = np.random.default_rng(2)
    params = (rng.standard_normal((N, D)) + 0.5).astype(np.float32)
    lw = (-2.0 * rng.uniform(size=N)).astype(np.float32)
    d = D
    if case == "rank_guard":
        # two effective samples in d=3: an exactly rank-deficient fit
        d = 3
        params = params[:, :3].copy()
        lw[:] = -np.inf
        lw[[4, 9]] = 0.0
    elif case == "pd_guard":
        # a non-finite sample with weight: the fit is not PD
        params[11, 2] = np.nan
    return d, lw, params


@pytest.mark.parametrize("case", ["full", "diagonal", "rank_guard",
                                  "pd_guard"])
def test_weighted_update_matches_reference(case):
    d, lw, params = _weighted_case(case)
    kw = {"diagonal": True} if case == "diagonal" else {}
    jfam, jstate, fam, state = _families(d, **kw)
    jnew, jess, jkl = jfam.weighted_update(jstate, jnp.asarray(lw),
                                           jnp.asarray(params))
    new, ess, kl = fam.weighted_update(state, to_torch(lw),
                                       to_torch(params))
    _states_close(new, jnew)
    _close(ess, jess, rtol=1e-5)
    if case in ("rank_guard", "pd_guard"):
        # both revert to the previous covariance, regularized
        reg = np.asarray(jstate.sigma) + 1e-6 * np.eye(d, dtype=np.float32)
        _close(new.sigma, reg, rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(jnew.sigma), reg)
    else:
        _close(kl, jkl, rtol=KL_RTOL, atol=1e-5)
    if case == "diagonal":
        sig = to_np(new.sigma)
        np.testing.assert_array_equal(sig, np.diag(np.diag(sig)))


def test_update_without_covariance_and_smoothing():
    d, lw, params = _weighted_case("full")
    jfam, jstate, fam, state = _families(d)
    jnew, _, jkl = jfam.weighted_update(jstate, jnp.asarray(lw),
                                        jnp.asarray(params),
                                        update_covariance=False)
    new, _, kl = fam.weighted_update(state, to_torch(lw), to_torch(params),
                                     update_covariance=False)
    _states_close(new, jnew, chol_tol=0)
    _close(kl, jkl, rtol=KL_RTOL, atol=1e-5)
    js = jfam.smooth_update(jstate, jnew.mu, 2.0 * jnew.sigma, 0.3)
    s = fam.smooth_update(state, new.mu, 2.0 * new.sigma, 0.3)
    _states_close(s, js)
    _states_close(fam.reset_covariance(s), jfam.reset_covariance(js),
                  chol_tol=1e-6)


def test_particle_injection_matches_reference(monkeypatch):
    jfam, jstate, fam, state = _families(sampler="PARTICLES",
                                         max_particles=3)
    rng = np.random.default_rng(3)
    elites = rng.standard_normal((4, D)).astype(np.float32)
    jstate = jfam.set_particles(jstate, jnp.asarray(elites), 2)
    state = fam.set_particles(state, to_torch(elites), 2)
    _close(state.particles, jstate.particles, rtol=0, atol=0)
    assert int(state.n_particles) == int(jstate.n_particles) == 2
    z = rng.standard_normal((N, D)).astype(np.float32)
    _feed_base(monkeypatch, z)
    jxs, _ = jfam.sample(jstate, jax.random.key(0), N)
    xs, _ = fam.sample(state, None, N)
    _close(xs, jxs)
    _close(xs[:2], to_np(state.mu) + elites[:2] @ to_np(state.chol).T)


@pytest.mark.parametrize("n_live", [0, 2, 5])
def test_inject_particles_matches_reference(n_live):
    rng = np.random.default_rng(4)
    z = rng.standard_normal((6, 3)).astype(np.float32)
    buf = rng.standard_normal((3, 3)).astype(np.float32)
    ref = jax_inject_particles(jnp.asarray(z), jnp.asarray(buf),
                               jnp.asarray(n_live, jnp.int32))
    got = inject_particles(to_torch(z), to_torch(buf),
                           torch.tensor(n_live, dtype=torch.int32))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


# ---- test functions ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_functions_match_reference(name):
    dim = 2 if name == "Himmelblau" else 6
    x = (2.0 * np.random.default_rng(5).standard_normal((16, dim))).astype(
        np.float32)
    kw = {"noise_std": 0.0} if name == "NoisySphere" else {}
    ref = jax_make_function(name, dim, **kw)(jax.random.key(0),
                                             jnp.asarray(x))
    fn = make_function(name, dim, seed=0, **kw)
    _close(fn(None, to_torch(x)), ref, rtol=1e-5, atol=1e-4)
    if hasattr(fn, "x_opt"):
        np.testing.assert_array_equal(fn.x_opt,
                                      jax_make_function(name, dim).x_opt)


def test_noisy_sphere_matrix_and_noise():
    jfn = jax_make_function("NoisySphere", 7, seed=3)
    fn = make_function("NoisySphere", 7, seed=3)
    np.testing.assert_array_equal(to_np(fn.quadratic("cpu")),
                                  np.asarray(jfn.quadratic))
    x = torch.randn(32, 7, generator=torch.Generator().manual_seed(0))
    quiet = make_function("NoisySphere", 7, seed=3, noise_std=0.0)
    noisy = fn(torch.Generator().manual_seed(9), x)
    noise = 0.01 * torch.randn(32, generator=torch.Generator().manual_seed(9))
    _close(noisy, quiet(None, x) + noise, rtol=0, atol=1e-5)


# ---- solvers ---------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(6)
    params = (rng.standard_normal((N, D)) + 0.3).astype(np.float32)
    costs = np.sum(params ** 2, axis=1).astype(np.float32)
    costs[[3, 17]] = np.nan
    return costs, params


def _both_updates(name, jstate_in=None):
    costs, params = _batch()
    kw = dict(n_elites=8, alpha=2.0, epsilon=0.5, delta=0.5, dimension=D)
    jfam, jstate, fam, state = _families(diagonal=name == "Cem",
                                         max_particles=3)
    jc, jv, jl = jax_mask_costs(jnp.asarray(costs))
    jsolver = jax_make_solver(name, **kw)
    jnew, jstats = jax.jit(lambda st, b: jsolver.update(
        jfam, jsolver.reset(jfam, st), b))(
            jstate, JaxBatch(jc, jnp.asarray(params), jv, jl))
    tc, tv, tl = mask_costs(to_torch(costs))
    batch = Batch(tc, to_torch(params), tv, tl)
    solver = make_solver(name, **kw)
    new, stats = solver.update(fam, solver.reset(fam, state), batch)
    return (jfam, jstate, jnew, jstats), (fam, state, new, stats, batch)


@pytest.mark.parametrize("name", ["Reps", "Lbps", "Essps", "Ais", "Mppi",
                                  "MppiUpdateCovariance"])
def test_weighting_solvers_match_reference(name):
    (_, _, jnew, jstats), (fam, state, new, stats, batch) = \
        _both_updates(name)
    alpha, ref_alpha = float(stats["alpha"]), float(jstats["alpha"])
    assert abs(np.log(alpha / ref_alpha)) <= 1.01 * CELL
    if alpha != ref_alpha:
        log_w = (-ref_alpha * minmax_normalize(batch.costs, batch.valid)
                 + batch.log_valid)
        new, ess, _ = fam.weighted_update(state, log_w, batch.params)
        stats = dict(stats, ess=ess)
    _states_close(new, jnew)
    _close(stats["ess"], jstats["ess"], rtol=1e-4)
    _close(stats["kl"], jstats["kl"], rtol=KL_RTOL, atol=1e-5)
    if name == "Essps":
        _close(stats["weight_ent"], jstats["weight_ent"], rtol=1e-4)


@pytest.mark.parametrize("name", ["Cem", "iCem"])
def test_elite_solvers_match_reference(name):
    (jfam, _, jnew, jstats), (fam, _, new, stats, batch) = \
        _both_updates(name)
    solver = make_solver(name, n_elites=8)
    jsolver = jax_make_solver(name, n_elites=8)
    jb = JaxBatch(*(jnp.asarray(to_np(v)) for v in batch))
    _, jidx = jsolver._elite_log_weights(jb)
    _, idx = solver._elite_log_weights(batch)
    assert set(to_np(idx).tolist()) == set(np.asarray(jidx).tolist())
    _states_close(new, jnew)
    _close(new.map_sequence, jnew.map_sequence, rtol=0, atol=0)
    _close(stats["weight_ent"], jstats["weight_ent"], rtol=1e-5)
    if name == "iCem":
        _close(new.particles, jnew.particles, rtol=0, atol=0)
        assert int(new.n_particles) == int(jnew.n_particles) == 2


def test_more_matches_reference():
    """MORE: the ridge fit, the damped-Newton dual and the PD-guarded
    interpolation. Both run 30 Newton iterations in f32 from the same
    batch; measured: mu and sigma 2-4e-5 apart, the dual's eta and omega
    3-6e-4 relative (a flat dual), held to 1e-3. The batch's costs are an
    exact quadratic, so the fit's RMSE sits at the f32 floor (2-3e-5) and
    is held to 1e-4 absolute."""
    (_, _, jnew, jstats), (_, _, new, stats, _) = _both_updates("More")
    _close(new.mu, jnew.mu, rtol=1e-3, atol=1e-3)
    _close(new.sigma, jnew.sigma, rtol=1e-3, atol=1e-3)
    for k in ("alpha", "omega", "kl", "fit", "ess"):
        _close(stats[k], jstats[k], rtol=1e-3, atol=1e-4)


def test_registry_matches_reference():
    from ppi_tpu.algorithms import ALGORITHMS as JAX_ALGORITHMS
    assert sorted(ALGORITHMS) == sorted(JAX_ALGORITHMS)
    for name in ALGORITHMS:
        assert ALGORITHMS[name].name == JAX_ALGORITHMS[name].name


# ---- samplers --------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 4, 9])
def test_cubature_points_are_exact(dim):
    np.testing.assert_array_equal(to_np(cubature_points(dim)),
                                  np.asarray(jax_cubature_points(dim)))
    with pytest.raises(ValueError, match="2\\*dim"):
        draw_base(SamplerKind.CUBATURE, None, 2 * dim + 1, dim, "cpu")


@pytest.mark.parametrize("n, dim", [(64, 5), (128, 20)])
def test_sobol_points_bit_equal_for_a_given_shift(n, dim):
    key = jax.random.key(11)
    shift = np.asarray(jax.random.bits(key, (1, dim), dtype=jnp.uint32)
                       >> 2).astype(np.int64)
    u = sobol_points(n, dim, torch.from_numpy(shift))
    np.testing.assert_array_equal(to_np(u),
                                  np.asarray(jax_sobol_uniform(key, n, dim)))
    np.testing.assert_allclose(to_np(uniform_to_normal(u)),
                               np.asarray(jax_sobol_normal(key, n, dim)),
                               rtol=1e-6, atol=1e-6)
    # unscrambled (zero shift): the plain Sobol sequence from SciPy
    from scipy.stats import qmc
    plain = qmc.Sobol(d=dim, scramble=False).random(n)
    np.testing.assert_allclose(
        to_np(sobol_points(n, dim, torch.zeros((1, dim), dtype=torch.int64))),
        plain + 0.5 * 2.0 ** -30, rtol=0, atol=2.0 ** -24)


def test_qmc_draw_is_seeded_and_normal():
    gen = lambda: torch.Generator().manual_seed(3)
    z = draw_base(SamplerKind.QUASI_MONTE_CARLO, gen(), 256, 6, "cpu")
    assert z.shape == (256, 6) and z.dtype == torch.float32
    assert torch.equal(z, draw_base(SamplerKind.QUASI_MONTE_CARLO, gen(),
                                    256, 6, "cpu"))
    assert float(z.mean().abs()) < 0.05 and abs(float(z.std()) - 1) < 0.05


# ---- a short solve ---------------------------------------------------------------

def test_short_solve_matches_reference(monkeypatch):
    """Reps on NoisySphere (no noise), d=8, N=64, 5 iterations, both
    packages' base draws pinned to one numpy array: each iteration's mean
    cost agrees (the first exactly up to rounding, later ones within the
    temperature near-ties)."""
    from ppi_tpu.algorithms import solve as jax_solve
    from ppi_tpu_torch.algorithms import solve
    d, n = 8, 64
    z = np.random.default_rng(7).standard_normal((n, d)).astype(np.float32)
    _feed_base(monkeypatch, z)
    jfam = jax_gaussian.Gaussian(dim=d)
    jstate = jfam.init(jnp.ones(d), 0.5 * jnp.eye(d))
    fam = gaussian.Gaussian(dim=d)
    state = fam.init(torch.ones(d), 0.5 * torch.eye(d))
    _, jtrace = jax_solve(jax_make_solver("Reps"), jfam, jstate,
                          jax_make_function("NoisySphere", d, noise_std=0.0),
                          jax.random.key(0), n, 5)
    new, trace = solve(make_solver("Reps"), fam, state,
                       make_function("NoisySphere", d, noise_std=0.0), None,
                       n, 5)
    np.testing.assert_allclose(to_np(trace["mean"][0]),
                               np.asarray(jtrace["mean"][0]), rtol=1e-6)
    np.testing.assert_allclose(to_np(trace["mean"]),
                               np.asarray(jtrace["mean"]), rtol=1e-3)
    assert float(trace["mean"][-1]) < float(trace["mean"][0])
    assert set(trace) == set(jtrace)


def test_divergences_match_reference():
    from ppi_tpu.ops import divergences as jdiv
    mu1, s1 = _prior(seed=8)
    mu2, s2 = _prior(seed=9)
    _close(ops.multivariate_gaussian_kl(*map(to_torch, (mu1, s1, mu2, s2))),
           jdiv.multivariate_gaussian_kl(*map(jnp.asarray,
                                              (mu1, s1, mu2, s2))),
           rtol=1e-5)
    _close(ops.multivariate_gaussian_entropy(to_torch(s1), D),
           jdiv.multivariate_gaussian_entropy(jnp.asarray(s1), D), rtol=1e-6)
    _close(ops.factorized(to_torch(s1)), np.diag(np.diag(s1)), rtol=0,
           atol=0)


def test_scalar_solvers_match_reference():
    """The ESS root find walks the same grids as JAX's to the same point;
    damped Newton lands on the same minimum of a smooth 2-D function."""
    from ppi_tpu.ops.scalar_opt import (
        grid_zoom_root_decreasing as jax_root, minimize_newton as jax_newton)
    costs = np.random.default_rng(10).uniform(size=128).astype(np.float32)
    c = to_torch(costs)

    def jax_ess(alpha):
        log_nw = -alpha * jnp.asarray(costs)
        log_nw = log_nw - jax.scipy.special.logsumexp(log_nw)
        return jnp.exp(-jax.scipy.special.logsumexp(2.0 * log_nw))

    def ess(alpha):
        log_nw = -alpha[:, None] * c[None, :]
        log_nw = log_nw - torch.logsumexp(log_nw, dim=1, keepdim=True)
        return torch.exp(-torch.logsumexp(2.0 * log_nw, dim=1))

    ref = float(jax.jit(lambda: jax_root(jax_ess, 10.0))())
    got = float(ops.grid_zoom_root_decreasing(ess, 10.0))
    assert got == pytest.approx(ref, rel=1e-5)
    assert float(ess(torch.tensor([got]))[0]) == pytest.approx(10.0, rel=0.01)

    def f_jax(x):
        return jnp.exp(x[0]) + x[0] * x[1] + 2.0 * x[1] ** 2 - x[0]

    def f(x):
        return torch.exp(x[0]) + x[0] * x[1] + 2.0 * x[1] ** 2 - x[0]

    jx, jf = jax.jit(lambda x0: jax_newton(f_jax, x0, iters=10))(
        jnp.zeros(2))
    x, fx = ops.minimize_newton(f, torch.zeros(2), iters=10)
    _close(x, jx, rtol=1e-4, atol=1e-5)
    _close(fx, jf, rtol=1e-5)
