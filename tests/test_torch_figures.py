"""The port's paper figures and animations (``runners/figures.py``,
``runners/animations.py``) and the noise priors' ``predict`` they need.

* ``predict`` of each noise family against JAX's after one weighted
  update on the same numpy samples and weights (bound 1e-6).
* ``fig_gp_shift``'s predicted mean and std, each of its four panels,
  against JAX's GP through the same calls: the means 1e-5 on every panel,
  the std 1e-5 on the first three; the last panel's std 2e-4 (measured
  1.3e-4, at the conditioned point after three window shifts, where the
  std is 0.063: both packages' f32 shifted-window solves sit 3.7e-4 from
  a float64 run of the port there, ROADMAP.md "Measured precision
  differences").
* The figures' three PNGs and the four GIFs at ``tests/test_animations.py``'s
  frame counts, with matplotlib and with the port's PIL stand-in (the
  card's machine has no matplotlib).
* The two scalar searches the animations use against JAX's: the root
  1e-5; the minimizer by its objective value, 1e-6 relative (the LBPS
  bound is flat at its minimum, so f32 noise moves the argmin by ~2e-4).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu import ops as jops
from ppi_tpu import policies as jpolicies
from ppi_tpu_torch import ops, policies
from ppi_tpu_torch.runners import animations, figures
from ppi_tpu_torch.utils import plotting


@pytest.mark.parametrize("name", ["WhiteNoiseIid", "ColouredNoise",
                                  "SmoothExplorationNoise",
                                  "SmoothActionNoise"])
def test_noise_predict_matches_jax(name):
    rng = np.random.default_rng(0)
    h, d, n = 8, 2, 16
    t = 0.05 * np.arange(h, dtype=np.float32)
    mean = np.array([0.1, -0.2], np.float32)
    cov_in = np.array([1.0], np.float32)
    cov_out = np.diag([0.3, 0.5]).astype(np.float32)
    params = rng.standard_normal((n, h, d)).astype(np.float32)
    log_w = rng.standard_normal(n).astype(np.float32)
    jfam, jstate = jpolicies.make_policy(
        name, jnp.asarray(t), d, jnp.asarray(mean), jnp.asarray(cov_in),
        jnp.asarray(cov_out), beta=0.5)
    fam, state = policies.make_policy(
        name, torch.from_numpy(t), d, torch.from_numpy(mean),
        torch.from_numpy(cov_in), torch.from_numpy(cov_out), beta=0.5,
        device="cpu")
    want0 = jfam.predict(jstate)
    got0 = fam.predict(state)
    jstate, _, _ = jfam.weighted_update(jstate, jnp.asarray(log_w),
                                        jnp.asarray(params))
    state, _, _ = fam.weighted_update(state, torch.from_numpy(log_w),
                                      torch.from_numpy(params))
    for want, got in ((want0, got0),
                      (jfam.predict(jstate), fam.predict(state))):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_gp_shift_panels_match_jax(tmp_path):
    """JAX's ``fig_gp_shift`` calls (``ppi_tpu/runners/figures.py:63-90``)
    through its own GP, against the panels the port's figure drew."""
    panels = figures.fig_gp_shift(tmp_path, device="cpu")
    h, dt = 40, 0.05
    t0 = dt * jnp.arange(h)
    fam, state = jpolicies.make_policy(
        "SquaredExponentialKernel", t0, 1, jnp.zeros(1), jnp.array([1.0]),
        jnp.eye(1), lengthscale=0.25)
    state = fam.compute_prior(state, t0)
    state = fam.condition(state, t0[15:16], jnp.array([[1.2]]))
    assert len(panels) == 4
    for (tt, m, s), std_tol in zip(panels, (1e-5, 1e-5, 1e-5, 2e-4)):
        mu, _, _, std = fam.predict(state)
        np.testing.assert_allclose(tt, np.asarray(state.t), atol=1e-5)
        np.testing.assert_allclose(m, np.asarray(mu[:, 0]), atol=1e-5)
        np.testing.assert_allclose(s, np.asarray(std[:, 0]), atol=std_tol)
        state = fam.update_timesteps(state, state.t + 5 * dt, anneal=1.0)
    assert (tmp_path / "gp_receding_horizon.png").stat().st_size > 1000


@pytest.fixture(params=["matplotlib", "raster"])
def backend(request, monkeypatch):
    """The plotting backend: matplotlib (here), or the PIL stand-in that a
    machine without matplotlib gets."""
    if request.param == "raster":
        for mod in (figures, animations):
            monkeypatch.setattr(mod, "_plt" if mod is figures else "pyplot",
                                lambda: plotting.RASTER)
    return request.param


def test_figures_write_their_files(tmp_path, backend):
    args = figures.build_parser().parse_args(
        ["--out", str(tmp_path), "--device", "cpu"])
    figures.main(args)
    for name in ("gaussian_ppi.png", "gp_receding_horizon.png",
                 "trajectory_priors.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


def test_animations_write_their_files(tmp_path, backend):
    """``tests/test_animations.py``'s frame counts: 3, 1 a solver, 3, 2."""
    from PIL import Image
    out = Path(tmp_path)
    paths = [animations.anim_gaussian_ppi(out, n_frames=3, device="cpu"),
             animations.anim_nonlinear_ppi(out, n_frames_per=1,
                                           device="cpu"),
             animations.anim_policy_time_shift(out, n_frames=3,
                                               device="cpu"),
             animations.anim_policy_time_resolution(out, n_frames=2,
                                                    device="cpu")]
    assert [p.name for p in paths] == [
        "gaussian_ppi.gif", "nonlinear_ppi.gif", "policy_time_shift.gif",
        "policy_time_resolution.gif"]
    for p, frames in zip(paths, (3, 3, 3, 2)):
        assert p.stat().st_size > 1000, p
        assert Image.open(p).n_frames == frames, p


def test_figure_runners_default_to_the_card():
    for mod in (figures, animations):
        assert mod.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            figures.main(figures.build_parser().parse_args([]))


def test_scalar_searches_match_jax():
    """``golden_section_min`` and ``bisect_decreasing`` on the LBPS bound and
    the ESS curve of ``anim_nonlinear_ppi``'s costs, against JAX's."""
    rng = np.random.default_rng(0)
    cn = rng.random(128).astype(np.float32)

    def ess(lse, exp, a, c):
        lw = -a * c
        nw = lw - lse(lw)
        return exp(-lse(2 * nw))

    jc, tc = jnp.asarray(cn), torch.from_numpy(cn)
    jess = lambda a: ess(jax.scipy.special.logsumexp, jnp.exp, a, jc)
    tess = lambda a: ess(lambda x: torch.logsumexp(x, 0), torch.exp, a, tc)
    for target in (64.0, 10.0):
        want = float(jops.bisect_decreasing(jess, target, 1e-3, 1e3))
        got = float(ops.bisect_decreasing(tess, target, 1e-3, 1e3))
        assert got == pytest.approx(want, rel=1e-5)
    jbound = lambda a: jnp.sum(jnp.exp(-a * jc - jax.scipy.special.logsumexp(
        -a * jc)) * jc) + 0.3 / jnp.sqrt(jess(a))
    tbound = lambda a: torch.sum(torch.exp(-a * tc - torch.logsumexp(
        -a * tc, 0)) * tc) + 0.3 / torch.sqrt(tess(a))
    want = float(jops.golden_section_min(jbound, 1e-3, 1e3, iters=60))
    got = float(ops.golden_section_min(tbound, 1e-3, 1e3, iters=60))
    assert got == pytest.approx(want, rel=1e-3)
    assert float(tbound(torch.tensor(got))) == pytest.approx(
        float(jbound(jnp.float32(want))), rel=1e-6)
