"""The port's Gaussian moment match against ppi_tpu.ops on the same inputs.

The JAX fused kernel runs in Pallas interpret mode on the CPU, as
tests/test_ops.py runs it; its tolerances are those of test_ops.py's
TestPallasMomentMatch. The port's plain versions (the kernel's single-pass
formula and the two-pass path) are also held to the float64 oracle of
tests/test_fuzz_solvers.py with its bounds. The kernel's source compiled as
host C (where ``cc`` exists) is the CPU model of the CUDA design: the same
prologue, tile pairs, cluster ranks, chunks, TF32 split into three
products and reduction orders. It is held to the plain version (mu and
sigma to 1e-5 absolute: f32 sums of unit-scale data in another order, and
products of TF32 parts whose dropped bits lie below 2^-22 of each value;
ESS to 1e-5 relative) and to the JAX kernel in interpret mode with
test_ops.py's tolerances. Its TF32 rounding is pinned on edge values.
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
from ppi_tpu_torch.build import LAUNCHES, build_library, load_function
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
    """The main kernel's ranks cover every row once in whole chunks, at
    most 8 a cluster and one block an SM or fewer; the prologue's parts
    cover every row once."""
    tile, rows, splits, parts, part_rows = plan(n, d)
    assert tile == (64 if d <= 64 else 128)
    assert rows % 32 == 0 and (splits - 1) * rows < n <= splits * rows
    pairs = (-(-d // tile)) * (-(-d // tile) + 1) // 2
    assert 1 <= splits <= 8 and pairs * splits <= 132 + pairs
    assert (parts - 1) * part_rows < n <= parts * part_rows <= n + parts
    assert 1 <= parts <= 32
    if (n, d) == (4096, 640):
        assert (tile, pairs, splits) == (128, 15, 8)


# the cases of the host-C model: ragged N and d, masked lanes, several
# ranks and several tiles (37 x 130 and 333 x 260: wider than a 128 tile)
HOST_CASES = CASES + [("random", 129, 65), ("masked_q", 4096, 64),
                      ("random", 37, 130), ("one_lane", 512, 64),
                      ("random", 333, 260)]


def _host_inputs(name, n, d):
    if name not in ("masked_q", "one_lane"):
        return _inputs(name, n, d)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, d)).astype(np.float32)
    lw = rng.normal(scale=3.0, size=n).astype(np.float32)
    if name == "masked_q":
        lw[rng.permutation(n)[: n // 4]] = -np.inf
    else:
        lw[:] = -np.inf
        lw[7] = 0.0
    return lw, x


@pytest.mark.parametrize("name, n, d", HOST_CASES)
def test_host_c_build_matches_plain(name, n, d):
    """Ragged N and d, masked lanes, several ranks and several tiles; two
    runs bit-identical, sigma exactly symmetric, one live lane ESS 1."""
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    lw, x = _host_inputs(name, n, d)
    got = m_projection_host(to_torch(lw), to_torch(x))
    again = m_projection_host(to_torch(lw), to_torch(x))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    mu, sigma, ess = (to_np(v) for v in got)
    mu0, sigma0, ess0 = (to_np(v) for v in m_projection_plain(
        to_torch(lw), to_torch(x)))
    assert mu.shape == (d,) and sigma.shape == (d, d) and ess.shape == ()
    np.testing.assert_allclose(mu, mu0, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(sigma, sigma0, atol=1e-5)
    np.testing.assert_allclose(ess, ess0, rtol=1e-5)
    np.testing.assert_array_equal(sigma, sigma.T)
    if name == "one_lane":
        assert float(ess) == 1.0
        np.testing.assert_allclose(mu, x[7], atol=1e-6)


@pytest.mark.parametrize("name, n, d", HOST_CASES)
def test_host_c_model_matches_pallas_interpret(name, n, d):
    """The host-C model against ``m_projection_pallas`` in interpret mode
    on the same inputs, with the tolerances of the plain version's test
    (``_check_against``: test_ops.py's)."""
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    lw, x = _host_inputs(name, n, d)
    ref = jax.device_get(m_projection_pallas(jnp.asarray(lw), jnp.asarray(x),
                                             interpret=True))
    _check_against(m_projection_host(to_torch(lw), to_torch(x)), ref,
                   "offset" if name == "offset" else "random")


def tf32_host(values):
    """The host-C build's ``mm_tf32`` on f32 ``values``."""
    src = np.ascontiguousarray(values, dtype=np.float32)
    out = np.empty_like(src)
    fn = load_function(build_library("moment_match.cu", host=True),
                       "ppi_mm_tf32", 2, 1, stream=False)
    assert fn(src.ctypes.data, out.ctypes.data, src.size) == 0
    return out


def test_tf32_rounding_of_edge_values():
    """``mm_tf32`` keeps the sign, exponent and 10 mantissa bits, rounding
    the 13 dropped bits to nearest with ties away from zero (as
    ``cvt.rna.tf32.f32``): a tie rounds up in magnitude for both signs,
    below a tie it rounds down; a subnormal rounds on the same bits;
    +-inf and +-0 pass through, NaN stays NaN; and a value and its TF32
    rounding differ by at most 2^-11 of the value."""
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    bits = np.array([
        0x3F800000,   # 1.0: exact
        0x3F801000,   # 1 + 2^-11: a tie, up to 1 + 2^-10
        0x3F800FFF,   # just below the tie: down to 1.0
        0x3F803000,   # 1 + 3 * 2^-11: a tie, up (away from zero)
        0xBF801000,   # -(1 + 2^-11): a tie, away from zero
        0xC0490FDB,   # -pi
        0x00001000,   # a subnormal at a tie
        0x00000FFF,   # a subnormal below it: 0
        0x7F800000, 0xFF800000,   # +inf, -inf
        0x00000000, 0x80000000,   # +0, -0
    ], dtype=np.uint32)
    want = np.array([
        0x3F800000, 0x3F802000, 0x3F800000, 0x3F804000, 0xBF802000,
        0xC0490000, 0x00002000, 0x00000000, 0x7F800000, 0xFF800000,
        0x00000000, 0x80000000], dtype=np.uint32)
    got = tf32_host(bits.view(np.float32)).view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(tf32_host(np.array([np.nan, -np.nan], np.float32))).all()
    v = np.random.default_rng(3).normal(size=4096).astype(np.float32)
    r = tf32_host(v)
    assert not (r.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(r - v) <= np.abs(v) * 2.0 ** -11).all()
    hi_lo = r + tf32_host(v - r)
    assert (np.abs(hi_lo - v) <= np.abs(v) * 2.0 ** -21).all()


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
