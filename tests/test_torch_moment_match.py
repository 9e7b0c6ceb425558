"""The port's Gaussian moment match against ppi_tpu.ops on the same inputs.

The JAX fused kernel runs in Pallas interpret mode on the CPU, as
tests/test_ops.py runs it; its tolerances are those of test_ops.py's
TestPallasMomentMatch. The port's plain versions (the kernel's single-pass
formula and the two-pass path) are also held to the float64 oracle of
tests/test_fuzz_solvers.py with its bounds. The kernel's source compiled as
host C (where ``cc`` exists) runs the same blocks, chunks and pass-2 sums as
the CUDA kernel and is held to the plain version: mu and sigma to 1e-5
absolute (f32 sums of unit-scale data in another order), ESS to 1e-5
relative.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
from ppi_tpu import ops as jops
from ppi_tpu.ops.pallas_ops import m_projection_pallas
from ppi_tpu_torch.build import LAUNCHES
from ppi_tpu_torch.ops import m_projection
from ppi_tpu_torch.ops.cuda_ops import (
    m_projection_cuda, m_projection_host, m_projection_plain, plan)

# (name, n, d): the cases of test_ops.py plus a ragged batch over JAX's
# 256-row tile
CASES = [("random", 300, 17), ("offset", 256, 9), ("masked", 128, 8),
         ("ragged", 1000, 33)]


def _inputs(name, n, d):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    lw = rng.normal(size=n).astype(np.float32)
    if name == "offset":
        x = (100.0 + 0.01 * x).astype(np.float32)
        lw = np.zeros(n, np.float32)
    elif name == "masked":
        lw = np.zeros(n, np.float32)
        lw[10:20] = -np.inf
    return lw, x


def _check_against(got, ref, name):
    mu, sigma, ess = (to_np(v) for v in got)
    mu0, sigma0, ess0 = (np.asarray(v) for v in ref)
    if name == "offset":
        # covariance scale 1e-4 under a mean of 100: centring must keep it
        np.testing.assert_allclose(mu, mu0, rtol=1e-6)
        np.testing.assert_allclose(np.diag(sigma), np.diag(sigma0),
                                   rtol=0.05, atol=1e-7)
        return
    np.testing.assert_allclose(mu, mu0, atol=1e-5)
    np.testing.assert_allclose(sigma, sigma0, atol=1e-5)
    np.testing.assert_allclose(ess, ess0, rtol=1e-4)


@pytest.mark.parametrize("name, n, d", CASES)
def test_plain_matches_pallas_interpret(name, n, d):
    lw, x = _inputs(name, n, d)
    ref = jax.device_get(m_projection_pallas(jnp.asarray(lw), jnp.asarray(x),
                                             interpret=True))
    _check_against(m_projection_plain(to_torch(lw), to_torch(x)), ref, name)


@pytest.mark.parametrize("name, n, d", CASES)
def test_two_pass_matches_reference(name, n, d):
    lw, x = _inputs(name, n, d)
    ref = jops.m_projection(jnp.asarray(lw), jnp.asarray(x),
                            use_pallas="never")
    got = m_projection(to_torch(lw), to_torch(x), use_kernel="never")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def _oracle(lw, x):
    """float64 moment match (tests/test_fuzz_solvers.py's oracle)."""
    lw, x = lw.astype(np.float64), x.astype(np.float64)
    w = np.exp(lw - lw[np.isfinite(lw)].max())
    w[~np.isfinite(lw)] = 0.0
    w /= w.sum()
    mu = w @ x
    dev = x - mu
    return mu, (w[:, None] * dev).T @ dev, 1.0 / np.sum(w ** 2)


@pytest.mark.parametrize("n_masked_q", [0, 1, 2, 3])
def test_plain_paths_match_float64_oracle(n_masked_q):
    """(4096, 64), heavy-tailed log-weights (scale 3, weights over e^+-9),
    0-3 quarters of the lanes masked."""
    n, d = 4096, 64
    rng = np.random.default_rng(100 + n_masked_q)
    x = rng.normal(size=(n, d)).astype(np.float32)
    lw = rng.normal(scale=3.0, size=n).astype(np.float32)
    lw[rng.permutation(n)[: (n * n_masked_q) // 4]] = -np.inf
    mu_o, s_o, e_o = _oracle(lw, x)
    for fn in (m_projection_plain,
               lambda l, s: m_projection(l, s, use_kernel="never")):
        mu, s, e = (to_np(v) for v in fn(to_torch(lw), to_torch(x)))
        np.testing.assert_allclose(mu, mu_o, atol=5e-4)
        np.testing.assert_allclose(s, s_o, rtol=2e-2, atol=5e-2)
        np.testing.assert_allclose(e, e_o, rtol=1e-3)


def test_dispatch_on_cpu_tensors():
    """"auto" on a CPU tensor above the threshold takes the two-pass path
    (as JAX does off the TPU); "always" takes the kernel's wrapper, which
    runs the plain version on the CPU. Neither counts a launch."""
    rng = np.random.default_rng(1)
    lw = to_torch(rng.normal(size=4096))
    x = to_torch(rng.normal(size=(4096, 64)))
    before = LAUNCHES["moment_match"]
    auto = m_projection(lw, x)
    never = m_projection(lw, x, use_kernel="never")
    always = m_projection(lw, x, use_kernel="always")
    plain = m_projection_plain(lw, x)
    assert all(torch.equal(a, b) for a, b in zip(auto, never))
    assert all(torch.equal(a, b) for a, b in zip(always, plain))
    assert all(torch.equal(a, b) for a, b in zip(
        m_projection_cuda(lw, x), plain))
    assert LAUNCHES["moment_match"] == before
    with pytest.raises(ValueError, match="use_kernel"):
        m_projection(lw, x, use_kernel="sometimes")


@pytest.mark.parametrize("n, d", [(4096, 64), (4000, 640), (1000, 17),
                                  (100, 20), (16384, 640), (7, 3)])
def test_plan_covers_every_row_once(n, d):
    rows, splits = plan(n, d)
    assert rows % 32 == 0 and (splits - 1) * rows < n <= splits * rows
    pairs = (-(-d // 64)) * (-(-d // 64) + 1) // 2
    assert pairs * splits <= 4 * 132 + pairs and splits < 65536


HOST_CASES = CASES + [("random", 129, 65), ("masked_q", 4096, 64),
                      ("random", 37, 130), ("one_lane", 512, 64)]


@pytest.mark.parametrize("name, n, d", HOST_CASES)
def test_host_c_build_matches_plain(name, n, d):
    """Ragged N and d, masked lanes, several splits and several tiles."""
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    if name in ("masked_q", "one_lane"):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(n, d)).astype(np.float32)
        lw = rng.normal(scale=3.0, size=n).astype(np.float32)
        if name == "masked_q":
            lw[rng.permutation(n)[: n // 4]] = -np.inf
        else:
            lw[:] = -np.inf
            lw[7] = 0.0
    else:
        lw, x = _inputs(name, n, d)
    got = m_projection_host(to_torch(lw), to_torch(x))
    again = m_projection_host(to_torch(lw), to_torch(x))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    mu, sigma, ess = (to_np(v) for v in got)
    mu0, sigma0, ess0 = (to_np(v) for v in m_projection_plain(
        to_torch(lw), to_torch(x)))
    np.testing.assert_allclose(mu, mu0, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(sigma, sigma0, atol=1e-5)
    np.testing.assert_allclose(ess, ess0, rtol=1e-5)
    np.testing.assert_array_equal(sigma, sigma.T)
    if name == "one_lane":
        assert float(ess) == 1.0
        np.testing.assert_allclose(mu, x[7], atol=1e-6)


def test_host_c_build_rejects_bad_inputs():
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    x = torch.zeros((64, 8))
    lw = torch.zeros(64)
    with pytest.raises(TypeError):
        m_projection_host(lw.double(), x)
    with pytest.raises(ValueError, match="contiguous"):
        m_projection_host(lw, torch.zeros((8, 64)).T)
    with pytest.raises(ValueError, match="shapes"):
        m_projection_host(torch.zeros(63), x)
