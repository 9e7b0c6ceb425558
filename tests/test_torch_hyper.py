"""The port's kernel hyperparameter fit (``BaseKernel.hyper_nll``,
``optimize_hyper``, ``param_bounds``) against ``ppi_tpu.policies.kernels``.

Both packages get the same numpy prior and target (H=8, d_a=2, the dt=0.02
grid in f32). The Grams are kept well conditioned (SE lengthscale 0.025 on
the 0.02 grid, Matern 3/2 0.06, periodic 0.25 with period 0.3): torch
(LAPACK) and XLA factor in different orders, and an ill-conditioned Gram
turns that f32 difference into more than the 1e-5 held here. Tolerances:
the NLL's value and gradient (``jax.grad`` against ``torch.autograd``)
1e-5 relative (the gradient normwise); 50 Adam steps of ``optimize_hyper``
1e-3 relative per hyperparameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.policies import make_policy

H, D, DT = 8, 2, 0.02
T = (DT * np.arange(H)).astype(np.float32)
MEAN = np.zeros(D, np.float32)
COV_OUT = np.array([[0.5, 0.1], [0.1, 0.3]], np.float32)
# name -> (prior's hyperparameters, the hyperparameters the NLL is taken at)
CASES = {
    "SquaredExponentialKernel": (dict(lengthscale=0.02), [1.3, 0.025]),
    "Matern32Kernel": (dict(lengthscale=0.05), [1.3, 0.06]),
    "PeriodicKernel": (dict(lengthscale=0.2, period=0.3), [1.3, 0.25, 0.3]),
}


def _target(seed=0):
    return np.random.default_rng(seed).normal(size=(H, D)).astype(np.float32)


def _pair(name, sigma=1.0, **kw):
    fj, sj = jax_make_policy(name, jnp.asarray(T), D, jnp.asarray(MEAN),
                             jnp.asarray([sigma], jnp.float32),
                             jnp.asarray(COV_OUT), **kw)
    ft, st = make_policy(name, torch.tensor(T), D, torch.tensor(MEAN),
                         torch.tensor([sigma]), torch.tensor(COV_OUT),
                         device="cpu", **kw)
    return (fj, sj), (ft, st)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hyper_nll_value_and_gradient_match_jax(name):
    kw, hyper = CASES[name]
    (fj, sj), (ft, st) = _pair(name, **kw)
    target = _target()
    val, grad = jax.value_and_grad(
        lambda h: fj.hyper_nll(sj, h, jnp.asarray(target)))(
            jnp.asarray(hyper, jnp.float32))
    h = torch.tensor(hyper, requires_grad=True)
    val_t = ft.hyper_nll(st, h, torch.tensor(target))
    grad_t, = torch.autograd.grad(val_t, h)
    assert _rel(float(val_t.detach()), float(val)) <= 1e-5
    assert _rel(to_np(grad_t), grad) <= 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimize_hyper_matches_jax(name):
    kw, _ = CASES[name]
    (fj, sj), (ft, st) = _pair(name, **kw)
    target = _target(1)
    got = ft.optimize_hyper(st, torch.tensor(target), steps=50)
    want = fj.optimize_hyper(sj, jnp.asarray(target), steps=50)
    assert not np.allclose(to_np(got.hyper), to_np(st.hyper))
    np.testing.assert_allclose(to_np(got.hyper), np.asarray(want.hyper),
                               rtol=1e-3)


def test_param_bounds_are_jax_s():
    for name in ("SquaredExponentialKernel", "PeriodicKernel",
                 "WhiteNoiseKernel", "Matern12Kernel",
                 "LinearGaussianDynamicalSystemKernel"):
        kw = dict(period=0.3) if name == "PeriodicKernel" else {}
        (fj, _), (ft, _) = _pair(name, **kw)
        assert ft.param_bounds == fj.param_bounds, name


@pytest.mark.parametrize("sigma,lengthscale,bound", [
    (2e-5, 0.02, (0, 1e-5)),      # a zero target pulls sigma to its floor
    (1.0, 5e3, (1, 1e3)),         # a lengthscale past its ceiling
])
def test_result_is_clamped_and_its_grams_consistent(sigma, lengthscale,
                                                    bound):
    (fj, sj), (ft, st) = _pair("SquaredExponentialKernel", sigma=sigma,
                               lengthscale=lengthscale)
    target = np.zeros((H, D), np.float32) if bound[0] == 0 else _target()
    got = ft.optimize_hyper(st, torch.tensor(target), steps=50)
    lo, hi = np.asarray(ft.param_bounds, np.float32).T
    hyper = to_np(got.hyper)
    assert np.all(hyper >= lo[:2]) and np.all(hyper <= hi[:2])
    assert hyper[bound[0]] == np.float32(bound[1])
    np.testing.assert_allclose(
        hyper, np.asarray(fj.optimize_hyper(sj, jnp.asarray(target),
                                            steps=50).hyper), rtol=1e-3)
    # the prior's grams are rebuilt at the optimum
    gram = ft.k(got, got.t, got.t)
    for field in ("cov_in", "cov_in_init", "cov_prior"):
        assert torch.equal(getattr(got, field), gram), field
    assert torch.equal(got.chol_prior, got.chol_in)
    torch.testing.assert_close(got.chol_in @ got.chol_in.T, got.cov_in,
                               rtol=1e-5, atol=1e-5 * float(gram.max()))
