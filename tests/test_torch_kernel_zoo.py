"""The port's kernel zoo (Matern 1/2, 3/2, 5/2, periodic, white noise,
LGDS) against ``ppi_tpu.policies.kernels``.

The time grid is built as the runners build it (``dt * arange`` in f32), so
``k_white``'s exact ``|t1 - t2| == 0`` test sees the same bits in both
packages. Tolerances, normwise (atol = rtol x max |reference|):

  * Gram functions, ``init``, ``sample``, ``predict``: 1e-5 (elementwise
    f32 arithmetic and one Cholesky of a well-conditioned Gram at
    lengthscale 0.05 on the dt = 0.02 grid);
  * ``weighted_update``, ``update_timesteps``, ``condition``,
    ``loglikelihood``: 1e-4, as tests/test_torch_policies.py holds the SE
    kernel: they solve against the Gram (condition number up to ~1e3 for
    Matern 5/2 here), and torch (LAPACK) and XLA factor in different
    orders;
  * the periodic kernel with the runner's ``period = dt`` makes every lag a
    whole period, so its Gram is rank one plus 1e-3 sigma I and its f32
    Cholesky factor is determined to ~1e-3 only: every factor is compared
    through L L^T, and what is solved against that Gram (the window shift,
    conditioning, the likelihood) is held to 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
import ppi_tpu.policies.kernels as jax_kernels
import ppi_tpu.policies.primitives as jax_primitives
import ppi_tpu_torch.policies.kernels as kernels
import ppi_tpu_torch.policies.primitives as primitives
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.convert import kernel_state_from_numpy
from ppi_tpu_torch.policies import (
    POLICY_NAMES, design_moments, make_policy)

H, D, N, DT = 8, 4, 64, 0.02
LOW = np.array([-1.5, -1.2, -2.0, -2.0], np.float32)
HIGH = -LOW
T = (DT * np.arange(H)).astype(np.float32)
LGDS = "LinearGaussianDynamicalSystemKernel"

CONFIGS = {
    "matern12": dict(name="Matern12Kernel", lengthscale=0.05),
    "matern32": dict(name="Matern32Kernel", lengthscale=0.05),
    "matern52": dict(name="Matern52Kernel", lengthscale=0.05),
    "periodic": dict(name="PeriodicKernel", lengthscale=0.05, period=DT),
    "periodic_long": dict(name="PeriodicKernel", lengthscale=0.5,
                          period=0.1),
    "white": dict(name="WhiteNoiseKernel"),
    "lgds2": dict(name=LGDS, lgds_order=2),
    "lgds3": dict(name=LGDS, lgds_order=3),
}
# solves against the rank-one-plus-jitter Gram (see the module docstring)
SOLVE_RTOL = {"periodic": 1e-2}


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _build(key):
    cfg = dict(CONFIGS[key])
    name = cfg.pop("name")
    jm, jci, jco = jax_design_moments(jnp.asarray(LOW), jnp.asarray(HIGH),
                                      1000.0)
    jfam, jstate = jax_make_policy(
        name, jnp.asarray(T), D, jm, jci, jco, lower=jnp.asarray(LOW),
        upper=jnp.asarray(HIGH), **cfg)
    m, ci, co = design_moments(to_torch(LOW), to_torch(HIGH), 1000.0)
    fam, state = make_policy(name, to_torch(T), D, m, ci, co,
                             lower=to_torch(LOW), upper=to_torch(HIGH),
                             device="cpu", **cfg)
    return jfam, jstate, fam, state, SOLVE_RTOL.get(key, 1e-4)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def policies(request):
    return _build(request.param)


@pytest.mark.parametrize("fn,hyper", [
    ("k_matern12", (2.0, 0.05)), ("k_matern32", (2.0, 0.05)),
    ("k_matern52", (2.0, 0.05)), ("k_periodic", (2.0, 0.05, DT)),
    ("k_periodic", (2.0, 0.5, 0.1)), ("k_white", (2.0,)),
    ("k_squared_exponential", (2.0, 0.05))])
def test_gram_functions_match_reference(fn, hyper):
    """On the window, against a shifted window of the same length and
    against a shorter set of times."""
    ref_fn, got_fn = getattr(jax_kernels, fn), getattr(kernels, fn)
    shifted = (DT * (np.arange(H) + 2)).astype(np.float32)
    for t1, t2 in ((T, T), (shifted, T), (T, T[[0, 3, 4]])):
        got = got_fn(to_torch(np.array(hyper, np.float32)), to_torch(t1),
                     to_torch(t2))
        assert got.shape == (t1.shape[0], t2.shape[0])
        _close(got, ref_fn(jnp.asarray(hyper, jnp.float32), jnp.asarray(t1),
                           jnp.asarray(t2)))


def test_white_gram_is_the_exact_time_match():
    shifted = (DT * (np.arange(H) + 2)).astype(np.float32)
    got = to_np(kernels.k_white(to_torch([3.0]), to_torch(shifted),
                                to_torch(T)))
    np.testing.assert_array_equal(got, 3.0 * np.eye(H, k=2, dtype=np.float32))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_lgds_gram_matches_reference(order):
    hyper = np.array([1000.0], np.float32)
    got = kernels.k_lgds(to_torch(hyper), to_torch(T), to_torch(T),
                         order=order)
    ref = jax_kernels.k_lgds(jnp.asarray(hyper), jnp.asarray(T),
                             jnp.asarray(T), order=order)
    _close(got, ref)
    j_dt = np.array([0.0, 0.02, 0.06], np.float32)
    np.testing.assert_array_equal(
        to_np(kernels.lgds_phi(order, to_torch(j_dt))),
        np.asarray(jax_kernels.lgds_phi(order, jnp.asarray(j_dt))))
    one = kernels.k_lgds(to_torch(hyper), to_torch(T[:1]), to_torch(T[:1]),
                         order=order)
    _close(one, jax_kernels.k_lgds(jnp.asarray(hyper), jnp.asarray(T[:1]),
                                   jnp.asarray(T[:1]), order=order))


def test_registry_matches_reference():
    assert POLICY_NAMES == list(
        __import__("ppi_tpu.policies", fromlist=["x"]).POLICY_NAMES)
    assert {k: v[1] for k, v in kernels.KERNELS.items()} == \
        {k: v[1] for k, v in jax_kernels.KERNELS.items()}


def test_init_matches_reference(policies):
    jfam, jstate, fam, state, _ = policies
    assert fam.dim_features == jfam.dim_features == H
    assert state.hyper.shape == jstate.hyper.shape
    for f in dataclasses.fields(state):
        if f.name.startswith("chol_") and f.name != "chol_out":
            continue
        _close(getattr(state, f.name), getattr(jstate, f.name))
    for chol, cov in ((state.chol_in, jstate.cov_in),
                      (state.chol_prior, jstate.cov_prior)):
        _close(chol @ chol.T, cov)
        assert torch.equal(chol, torch.tril(chol))


def _z():
    return np.random.default_rng(0).standard_normal((N, H * D)).astype(
        np.float32)


def _updated(policies, monkeypatch):
    jfam, jstate, fam, state, _ = policies
    z = _z()
    monkeypatch.setattr(jax_primitives, "draw_base",
                        lambda kind, key, n, dim: jnp.asarray(z))
    monkeypatch.setattr(primitives, "draw_base",
                        lambda kind, gen, n, dim, device: to_torch(z))
    # both packages sample from the reference's factor: the periodic
    # Gram's own factor is not determined to f32 (module docstring)
    state = state.replace(chol_in=to_torch(jstate.chol_in))
    jxs, _ = jfam.sample(jstate, jax.random.key(0), N)
    xs, params = fam.sample(state, None, N)
    lw = (3.0 * np.random.default_rng(1).standard_normal(N)).astype(
        np.float32)
    lw[[2, 9]] = -np.inf
    return (jxs, xs), (jfam.weighted_update(jstate, jnp.asarray(lw), jxs),
                       fam.weighted_update(state, to_torch(lw), xs))


def test_sample_from_the_same_base_draw(policies, monkeypatch):
    (jxs, xs), _ = _updated(policies, monkeypatch)
    assert xs.shape == (N, H, D)
    _close(xs, jxs)
    assert bool((xs >= to_torch(LOW)).all() and (xs <= to_torch(HIGH)).all())


def test_weighted_update_matches_reference(policies, monkeypatch):
    _, ((jnew, jess, _), (new, ess, kl)) = _updated(policies, monkeypatch)
    for f in ("mean", "cov_in", "map_sequence"):
        _close(getattr(new, f), getattr(jnew, f), 1e-4)
    _close(new.chol_in @ new.chol_in.T, jnew.cov_in, 1e-4)
    _close(ess, jess, 1e-4)
    assert float(kl) == 0.0


@pytest.mark.parametrize("shift", [0, 1, 3])
def test_update_timesteps_matches_reference(policies, monkeypatch, shift):
    """anneal 0.5; shift 0 is the unchanged window (a no-op). The white
    kernel remaps indices; the others condition through the prior. The
    LGDS Gram ignores its second argument, so its "cross-covariance" to the
    old window is the new window's Gram in both packages, as in an MPC
    episode with that prior."""
    jfam, _, fam, _, rtol = policies
    _, ((jnew, _, _), (new, _, _)) = _updated(policies, monkeypatch)
    t_new = (DT * (np.arange(H) + shift)).astype(np.float32)
    jshift = jfam.update_timesteps(jnew, jnp.asarray(t_new), 0.5)
    got = fam.update_timesteps(new, to_torch(t_new), 0.5,
                               same=shift == 0 or None)
    for f in ("t", "mean", "cov_in"):
        _close(getattr(got, f), getattr(jshift, f), rtol)
    _close(got.chol_in @ got.chol_in.T, jshift.cov_in, rtol)
    assert torch.equal(got.chol_in, torch.tril(got.chol_in))
    if shift == 0:
        assert got.cov_in is new.cov_in


def test_white_shift_keeps_the_overlap_and_resets_the_rest(monkeypatch):
    policies = _build("white")
    fam = policies[2]
    _, (_, (new, _, _)) = _updated(policies, monkeypatch)
    t_new = (DT * (np.arange(H) + 3)).astype(np.float32)
    got = fam.update_timesteps(new, to_torch(t_new), 1.0)
    assert torch.equal(got.mean[:H - 3], new.mean[3:])
    assert torch.equal(got.mean[H - 3:], torch.zeros(3, D))
    _close(got.cov_in[:H - 3, :H - 3], new.cov_in[3:, 3:])
    _close(got.cov_in[H - 3:, H - 3:], new.cov_in_init[:3, :3])


def test_condition_matches_reference(policies):
    """The white and LGDS kernels condition on points of the grid (the
    white kernel correlates nothing else; the LGDS Gram exists nowhere
    else) and their mean then passes through the observations. The others
    condition between grid points: on the grid the posterior covariance of
    a jitter-free Matern Gram is singular at the observed rows, and whether
    its f32 factorization fails is decided by rounding (XLA then returns
    NaN, LAPACK a partial factor). The LGDS sub-Gram has condition number
    2.7e4 (order 2), so both packages are ~1e-3 off a float64 evaluation
    and are held to 1e-2 of each other."""
    jfam, jstate, fam, state, rtol = policies
    on_grid = fam.kernel in ("WhiteNoiseKernel", LGDS)
    if fam.kernel == LGDS:
        rtol = 1e-2
    rng = np.random.default_rng(4)
    t = T[[1, 4, 6]] + np.float32(0.0 if on_grid else 0.5 * DT)
    action = (0.5 * rng.standard_normal((3, D))).astype(np.float32)
    jnew = jfam.condition(jstate, jnp.asarray(t), jnp.asarray(action))
    new = fam.condition(state, to_torch(t), to_torch(action))
    assert bool(torch.isfinite(new.cov_in).all())
    _close(new.mean, jnew.mean, rtol)
    _close(new.cov_in, jnew.cov_in, rtol)
    _close(new.chol_in @ new.chol_in.T, jnew.cov_in, rtol)
    if on_grid:
        np.testing.assert_allclose(
            to_np(state.mean_fn[None, :] + new.mean[[1, 4, 6]]), action,
            atol=2e-2)


def test_predict_and_loglikelihood_match_reference(policies, monkeypatch):
    jfam, _, fam, _, rtol = policies
    (jxs, xs), ((jnew, _, _), (new, _, _)) = _updated(policies, monkeypatch)
    for got, ref in zip(fam.predict(new), jfam.predict(jnew)):
        _close(got, ref, 1e-4)
    _close(fam.predict_mean(new), jfam.predict_mean(jnew), 1e-4)
    _close(fam.map_action_sequence(new), jfam.map_action_sequence(jnew))
    # the same factor in both, as in ``_updated``
    new = new.replace(chol_in=to_torch(jnew.chol_in))
    _close(fam.loglikelihood(new, xs), jfam.loglikelihood(jnew, jxs), rtol)


def test_converter_carries_one_to_three_hyperparameters(policies):
    _, jstate, _, state, _ = policies
    fields = {f.name: np.asarray(getattr(jstate, f.name))
              for f in dataclasses.fields(state)}
    got = kernel_state_from_numpy(fields, "cpu")
    assert got.hyper.shape == state.hyper.shape
    for f in dataclasses.fields(state):
        np.testing.assert_array_equal(to_np(getattr(got, f.name)),
                                      fields[f.name])


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        kernels.BaseKernel(horizon=H, action_dim=D, kernel="Matern72Kernel")
