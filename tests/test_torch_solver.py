"""The port's cost masking and LBPS update against ppi_tpu.algorithms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
from ppi_tpu.algorithms import make_solver as jax_make_solver
from ppi_tpu.algorithms.base import Batch as JaxBatch
from ppi_tpu.algorithms.base import mask_costs as jax_mask_costs
from ppi_tpu.algorithms.base import masked_mean_std as jax_masked_mean_std
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.algorithms import Batch, make_solver, mask_costs
from ppi_tpu_torch.algorithms.base import masked_mean_std, minmax_normalize
from ppi_tpu_torch.ops import ALPHA_LOWER, ALPHA_UPPER
from ppi_tpu_torch.policies import design_moments, make_policy

H, D, N = 8, 4, 64
LOW = np.array([-1.5, -1.2, -2.0, -2.0], np.float32)


def _costs(case):
    c = (10.0 + 3.0 * np.random.default_rng(0).standard_normal(N)).astype(
        np.float32)
    if case == "some_nan":
        c[[1, 5, 6]] = np.nan
        c[7] = np.inf
    elif case == "all_nan":
        c[:] = np.nan
    return c


@pytest.mark.parametrize("case", ["clean", "some_nan", "all_nan"])
def test_mask_costs_matches_reference(case):
    c = _costs(case)
    ref = jax_mask_costs(jnp.asarray(c))
    got = mask_costs(to_torch(c))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(to_np(g), np.asarray(r))
    ref_ms = jax_masked_mean_std(ref[0], ref[1])
    got_ms = masked_mean_std(got[0], got[1])
    for r, g in zip(ref_ms, got_ms):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=1e-6)


def _lbps_bound(alpha, costs_n, valid, delta=0.9):
    """The LBPS objective in float64 (numpy)."""
    log_w = np.where(valid, -alpha * costs_n.astype(np.float64), -np.inf)
    log_nw = log_w - np.logaddexp.reduce(log_w)
    ess = np.exp(-np.logaddexp.reduce(2.0 * log_nw))
    return np.sum(np.exp(log_nw) * costs_n) + np.sqrt((1 - delta) / delta
                                                      ) / np.sqrt(ess)


@pytest.mark.parametrize("case", ["clean", "some_nan"])
def test_lbps_update_matches_reference(case):
    """Same batch, same prior: the same temperature grid point, ESS and
    posterior (rtol 1e-4 normwise, see test_torch_policies).

    The bound is flat at its minimum, so rounding may tip the final argmin
    to the neighbouring grid point (one final zoom cell, 0.11% in alpha).
    The test then checks that the two points tie in float64 and compares
    the posterior at the reference's temperature."""
    t = 0.02 * np.arange(H, dtype=np.float32)
    jm, jci, jco = jax_design_moments(jnp.asarray(LOW), jnp.asarray(-LOW),
                                      1000.0)
    jfam, jstate = jax_make_policy(
        "SquaredExponentialKernel", jnp.asarray(t), D, jm, jci, jco,
        lengthscale=0.08, lower=jnp.asarray(LOW), upper=jnp.asarray(-LOW))
    m, ci, co = design_moments(to_torch(LOW), to_torch(-LOW), 1000.0)
    fam, state = make_policy("SquaredExponentialKernel", to_torch(t), D, m,
                             ci, co, lengthscale=0.08, lower=to_torch(LOW),
                             upper=to_torch(-LOW), device="cpu")
    params = np.clip(np.random.default_rng(1).standard_normal((N, H, D)),
                     LOW, -LOW).astype(np.float32)
    c = _costs(case)
    jc, jv, jl = jax_mask_costs(jnp.asarray(c))
    jnew, jstats = jax_make_solver("Lbps", delta=0.9).update(
        jfam, jstate, JaxBatch(jc, jnp.asarray(params), jv, jl))
    tc, tv, tl = mask_costs(to_torch(c))
    new, stats = make_solver("Lbps", delta=0.9).update(
        fam, state, Batch(tc, to_torch(params), tv, tl))

    alpha, ref_alpha = float(stats["alpha"]), float(jstats["alpha"])
    cell = np.log(ALPHA_UPPER / ALPHA_LOWER) / 63 * 2 / 32 * 2 / 32
    assert abs(np.log(alpha / ref_alpha)) <= 1.01 * cell
    if alpha != ref_alpha:
        costs_n = to_np(minmax_normalize(tc, tv))
        b, ref_b = (_lbps_bound(a, costs_n, to_np(tv))
                    for a in (alpha, ref_alpha))
        assert b == pytest.approx(ref_b, rel=1e-6)
        log_w = -ref_alpha * minmax_normalize(tc, tv) + tl
        new, ess, _ = fam.weighted_update(state, log_w, to_torch(params))
        stats = dict(stats, ess=ess)
    assert float(stats["ess"]) == pytest.approx(float(jstats["ess"]),
                                                rel=1e-4)
    for f in ("mean", "cov_in", "map_sequence"):
        ref = np.asarray(getattr(jnew, f))
        np.testing.assert_allclose(to_np(getattr(new, f)), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_unported_solvers_raise():
    with pytest.raises(ValueError, match="unknown solver"):
        make_solver("Cma")


def test_solve_matches_reference(monkeypatch):
    """The host-driven loop: 3 LBPS iterations on a quadratic objective with
    the base draws of both packages pinned to one numpy array."""
    import jax
    import ppi_tpu.policies.primitives as jax_primitives
    import ppi_tpu_torch.policies.primitives as primitives
    from ppi_tpu.algorithms import solve as jax_solve
    from ppi_tpu_torch.algorithms import solve

    z = np.random.default_rng(5).standard_normal((N, H * D)).astype(
        np.float32)
    monkeypatch.setattr(jax_primitives, "draw_base",
                        lambda kind, key, n, dim: jnp.asarray(z))
    monkeypatch.setattr(primitives, "draw_base",
                        lambda kind, gen, n, dim, device: to_torch(z))
    t = 0.02 * np.arange(H, dtype=np.float32)
    jm, jci, jco = jax_design_moments(jnp.asarray(LOW), jnp.asarray(-LOW),
                                      1000.0)
    jfam, jstate = jax_make_policy(
        "SquaredExponentialKernel", jnp.asarray(t), D, jm, jci, jco,
        lengthscale=0.08, lower=jnp.asarray(LOW), upper=jnp.asarray(-LOW))
    m, ci, co = design_moments(to_torch(LOW), to_torch(-LOW), 1000.0)
    fam, state = make_policy("SquaredExponentialKernel", to_torch(t), D, m,
                             ci, co, lengthscale=0.08, lower=to_torch(LOW),
                             upper=to_torch(-LOW), device="cpu")
    jnew, jtrace = jax_solve(
        jax_make_solver("Lbps"), jfam, jstate,
        lambda key, a: jnp.sum((a - 0.3) ** 2, axis=(1, 2)),
        jax.random.key(0), N, 3)
    seen = []
    new, trace = solve(
        make_solver("Lbps"), fam, state,
        lambda gen, a: torch.sum((a - 0.3) ** 2, dim=(1, 2)), None, N, 3,
        callback=lambda i, *_: seen.append(i) or False)
    assert seen == [0, 1, 2] and trace["mean"].shape == (3,)
    # the first batch is the same in both; later ones inherit the flat LBPS
    # bound's temperature differences (see test_torch_mpc), measured 2e-4
    np.testing.assert_allclose(to_np(trace["mean"][0]),
                               np.asarray(jtrace["mean"][0]), rtol=1e-6)
    np.testing.assert_allclose(to_np(trace["mean"]),
                               np.asarray(jtrace["mean"]), rtol=1e-3)
    ref = np.asarray(jnew.mean)
    np.testing.assert_allclose(to_np(new.mean), ref, rtol=1e-3,
                               atol=1e-3 * np.abs(ref).max())
