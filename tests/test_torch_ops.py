"""The port's ops against ppi_tpu.ops on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp as jax_logsumexp

from torch_helpers import to_np, to_torch
from ppi_tpu import ops as jops
from ppi_tpu.algorithms.base import minmax_normalize as jax_minmax_normalize
from ppi_tpu.ops.scalar_opt import grid_zoom_min as jax_grid_zoom_min
from ppi_tpu_torch import ops
from ppi_tpu_torch.algorithms.base import minmax_normalize


def _log_w(n=64, masked=(3, 17, 40), seed=0):
    lw = (5.0 * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)
    lw[list(masked)] = -np.inf
    return lw


@pytest.mark.parametrize("name", ["normalize_log_weights", "log_weight_stats",
                                  "effective_sample_size", "weight_entropy"])
def test_weighting_matches_reference(name):
    lw = _log_w()
    if name in ("effective_sample_size", "weight_entropy"):
        lw = np.asarray(jops.normalize_log_weights(jnp.asarray(lw)))
    ref = getattr(jops, name)(jnp.asarray(lw))
    got = getattr(ops, name)(to_torch(lw))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(to_np(g), np.asarray(r), atol=1e-6)


def test_select_row_takes_first_maximum():
    lw = _log_w()
    lw[[10, 30]] = 50.0  # a tie: both take the first
    params = np.random.default_rng(1).standard_normal((64, 8, 4)).astype(
        np.float32)
    ref = jops.select_row(jnp.asarray(params), jnp.asarray(lw))
    got = ops.select_row(to_torch(params), to_torch(lw))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    np.testing.assert_array_equal(to_np(got), params[10])


def test_safe_cholesky_ok_flags():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    pd = (a @ a.T + 6.0 * np.eye(6)).astype(np.float32)
    not_pd = pd.copy()
    not_pd[0, 0] = -1.0
    for mat, expect in ((pd, True), (not_pd, False)):
        chol, ok = ops.safe_cholesky(to_torch(mat), jitter=0.0)
        ref_chol, ref_ok = jops.safe_cholesky(jnp.asarray(mat), jitter=0.0)
        assert bool(ok) == bool(ref_ok) == expect
        if expect:
            np.testing.assert_allclose(to_np(chol), np.asarray(ref_chol),
                                       rtol=1e-5, atol=1e-6)
    _, ok_nan = ops.safe_cholesky(to_torch(np.full((3, 3), np.nan)))
    assert not bool(ok_nan)


@pytest.mark.parametrize("iterations, update_out", [(1, False), (2, True)])
def test_m_projection_mavn_matches_reference(iterations, update_out):
    rng = np.random.default_rng(3)
    n, h, d = 64, 8, 4
    lw = _log_w(n)
    samples = rng.standard_normal((n, h, d)).astype(np.float32)
    a = rng.standard_normal((h, h)).astype(np.float32)
    cov_in = (a @ a.T + h * np.eye(h)).astype(np.float32)
    cov_out = np.diag(rng.uniform(0.5, 2.0, d)).astype(np.float32)
    ref = jops.m_projection_mavn(jnp.asarray(lw), jnp.asarray(samples),
                                 jnp.asarray(cov_in), jnp.asarray(cov_out),
                                 iterations=iterations,
                                 update_out=update_out)
    got = ops.m_projection_mavn(to_torch(lw), to_torch(samples),
                                to_torch(cov_in), to_torch(cov_out),
                                iterations=iterations, update_out=update_out)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_grid_zoom_min_lands_on_the_reference_grid_point():
    """A fixed LBPS bound over fixed normalized costs: both searches walk
    the same grids (jnp.linspace's arithmetic) to the same point."""
    rng = np.random.default_rng(4)
    costs = rng.uniform(0.0, 1.0, 128).astype(np.float32)
    costs[:3] = [0.0, 0.02, 1.0]
    lam = float(np.sqrt(0.1 / 0.9))

    def jax_bound(alpha):
        log_w = -alpha * jnp.asarray(costs)
        log_nw = log_w - jax_logsumexp(log_w)
        ess = jnp.exp(-jax_logsumexp(2.0 * log_nw))
        return jnp.sum(jnp.exp(log_nw) * costs) + lam / jnp.sqrt(ess)

    c = to_torch(costs)

    def torch_bound(alpha):
        log_w = -alpha[:, None] * c[None, :]
        log_nw = log_w - torch.logsumexp(log_w, dim=1, keepdim=True)
        ess = torch.exp(-torch.logsumexp(2.0 * log_nw, dim=1))
        return torch.sum(torch.exp(log_nw) * c[None], dim=1) + lam / ess.sqrt()

    ref = float(jax_grid_zoom_min(jax_bound))
    got = float(ops.grid_zoom_min(torch_bound))
    assert got == pytest.approx(ref, rel=1e-5)
    assert ops.ALPHA_LOWER < got < ops.ALPHA_UPPER


def test_minmax_normalize_masked_lanes_stay_finite():
    """The overflow case: a near-degenerate valid range with huge masked
    placeholder costs must give finite normalized costs and weights."""
    costs = np.array([1.0, 1.0 + 1e-6, 3e38, 0.0, 1.0], np.float32)
    valid = np.array([True, True, False, False, True])
    ref = jax_minmax_normalize(jnp.asarray(costs), jnp.asarray(valid))
    got = minmax_normalize(to_torch(costs), torch.tensor(valid))
    assert np.isfinite(to_np(got)).all()
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)
    log_w = -500.0 * got + torch.where(torch.tensor(valid), 0.0, -torch.inf)
    assert not torch.isnan(ops.normalize_log_weights(log_w)).any()
