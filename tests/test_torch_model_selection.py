"""The port's model selection (``ppi_tpu_torch.model_selection``) against
``ppi_tpu.model_selection``, and ``run_mpc --model-selection``.

Both packages get the same numpy expert actions: a smooth two-dimensional
signal with 5% noise, cut into H=10 windows on the dt=0.05 grid (f32).
Tolerances: the windows and the matrix-normal moments 1e-5 (normwise); the
Adam fit of the kernel hyperparameters, 200 steps, 1e-3 relative in each
hyperparameter and 1e-4 (of 1 + |KL|) in the KL; the whole pipeline (1,500
steps) 1e-3. The artifact is one npz layout: each package reads the
other's. The fitted prior that ``run_mpc --model-selection`` builds is held
to the one JAX's ``goal_success.build_canonical_agent`` builds from the
same artifact, with and without ``--ms-fitted-scale``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np
import ppi_tpu.model_selection as jax_ms
import ppi_tpu.policies.kernels as jax_kernels
import ppi_tpu_torch.model_selection as ms
import ppi_tpu_torch.policies.kernels as kernels

H, DT = 10, 0.05
T = (DT * np.arange(H)).astype(np.float32)


def _actions(n=80, seed=4):
    t = np.arange(n) * DT
    base = np.stack([np.sin(0.7 * t), np.cos(1.3 * t)], axis=1)
    noise = 0.05 * np.random.default_rng(seed).normal(size=base.shape)
    return (base + noise).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def moments():
    acts = _actions()
    windows = ms.action_windows(torch.tensor(acts), H)
    return (acts, windows, ms.extract_matrix_normal_moments(windows),
            jax_ms.extract_matrix_normal_moments(
                jax_ms.action_windows(jnp.asarray(acts), H)))


def test_windows_and_moments_match_jax(moments):
    acts, windows, got, want = moments
    np.testing.assert_array_equal(
        to_np(windows), np.asarray(jax_ms.action_windows(jnp.asarray(acts),
                                                         H)))
    assert windows.shape == (71, H, 2)
    for g, w in zip(got, want):
        assert _rel(to_np(g), w) <= 1e-5


@pytest.mark.parametrize("name,fn", [
    ("SquaredExponentialKernel", "k_squared_exponential"),
    ("Matern32Kernel", "k_matern32"),
    ("PeriodicKernel", "k_periodic"),
])
def test_fit_kernel_hyperparams_matches_jax(moments, name, fn):
    _, _, (_, cov_in, _), (_, cov_in_j, _) = moments
    hyper0 = ms.default_kernels(DT)[name][1]
    got, kl = ms.fit_kernel_hyperparams(
        getattr(kernels, fn), torch.tensor(T), cov_in, torch.tensor(hyper0),
        steps=200)
    want, kl_j = jax_ms.fit_kernel_hyperparams(
        getattr(jax_kernels, fn), jnp.asarray(T), cov_in_j,
        jnp.asarray(hyper0, jnp.float32), steps=200)
    assert not np.allclose(to_np(got), hyper0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-3)
    assert abs(float(kl) - float(kl_j)) <= 1e-4 * (1.0 + abs(float(kl_j)))


def test_default_kernels_name_the_same_families():
    got, want = ms.default_kernels(DT), jax_ms.default_kernels(DT)
    assert list(got) == list(want)
    for name in got:
        assert got[name][0].__name__ == want[name][0].__name__
        assert got[name][1] == want[name][1]


@pytest.fixture(scope="module")
def selected():
    acts = _actions()
    kernels_ = {"SquaredExponentialKernel":
                ms.default_kernels(DT)["SquaredExponentialKernel"]}
    jax_kernels_ = {"SquaredExponentialKernel":
                    jax_ms.default_kernels(DT)["SquaredExponentialKernel"]}
    return (ms.select_model(acts, H, kernels_, t=T, device="cpu"),
            jax_ms.select_model(acts, H, jax_kernels_, t=jnp.asarray(T)))


def test_select_model_end_to_end_matches_jax(selected):
    got, want = selected
    assert list(got) == list(want) == ["SquaredExponentialKernel"]
    g, w = got["SquaredExponentialKernel"], want["SquaredExponentialKernel"]
    assert sorted(g) == sorted(w) == ["covariance_out", "kl", "mean",
                                      "param"]
    assert g["mean"].shape == (2,) and g["covariance_out"].shape == (2, 2)
    assert _rel(g["mean"], w["mean"]) <= 1e-5
    assert _rel(g["covariance_out"], w["covariance_out"]) <= 1e-5
    np.testing.assert_allclose(g["param"], w["param"], rtol=1e-3)
    assert abs(g["kl"] - w["kl"]) <= 1e-3 * (1.0 + abs(w["kl"]))
    # pre-windowed episodes take the D4RL path: the first H steps of each
    windows = np.stack([_actions(30, seed) for seed in range(5)])
    eps = ms.select_model(windows, H, {"SquaredExponentialKernel": (
        kernels.k_squared_exponential, (1.0, 5 * DT))}, t=T, device="cpu")
    eps_j = jax_ms.select_model(windows, H, {"SquaredExponentialKernel": (
        jax_kernels.k_squared_exponential, (1.0, 5 * DT))}, t=jnp.asarray(T))
    np.testing.assert_allclose(eps["SquaredExponentialKernel"]["param"],
                               eps_j["SquaredExponentialKernel"]["param"],
                               rtol=1e-3)


def test_artifact_reads_across_packages(selected, tmp_path):
    got, want = selected
    ms.save_model_selection(tmp_path / "torch.npz", got)
    jax_ms.save_model_selection(tmp_path / "jax.npz", want)
    for path, payload, load in ((tmp_path / "torch.npz", got,
                                 jax_ms.load_model_selection),
                                (tmp_path / "jax.npz", want,
                                 ms.load_model_selection)):
        back = load(path)
        assert list(back) == list(payload)
        for name, entry in payload.items():
            assert sorted(back[name]) == sorted(entry)
            for k, v in entry.items():
                np.testing.assert_array_equal(np.asarray(back[name][k]),
                                              np.asarray(v))


def test_cli_writes_an_artifact(tmp_path):
    np.savez(tmp_path / "expert.npz", actions=_actions(40))
    args = ms.build_parser().parse_args(
        ["--expert", str(tmp_path / "expert.npz"), "--horizon", "8",
         "--dt", str(DT), "--out", str(tmp_path / "ms.npz"), "--device",
         "cpu"])
    assert args.episode_length == 1000
    payload = ms.main(args)
    back = ms.load_model_selection(tmp_path / "ms.npz")
    assert sorted(back) == sorted(payload) == sorted(ms.default_kernels(DT))
    assert all(np.all(np.isfinite(e["param"])) for e in back.values())
    # --kernels fits only the families it names, each as the full run does
    one = ms.main(ms.build_parser().parse_args(
        ["--expert", str(tmp_path / "expert.npz"), "--horizon", "8",
         "--dt", str(DT), "--out", str(tmp_path / "se.npz"), "--device",
         "cpu", "--kernels", "SquaredExponentialKernel"]))
    assert list(one) == ["SquaredExponentialKernel"]
    np.testing.assert_array_equal(one["SquaredExponentialKernel"]["param"],
                                  payload["SquaredExponentialKernel"]
                                  ["param"])


def test_cli_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = ms.build_parser().parse_args(["--expert", "x.npz"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ms.select_model(_actions(20), 8, {}, device=args.device)


ARTIFACT = {"SquaredExponentialKernel": {
    "mean": np.array([0.1, -0.2, 0.05, 0.3], np.float32),
    "covariance_out": np.array([[0.02, 0.004, 0.0, 0.001],
                                [0.004, 0.03, 0.002, 0.0],
                                [0.0, 0.002, 0.01, 0.003],
                                [0.001, 0.0, 0.003, 0.05]], np.float32),
    "param": np.array([0.7, 0.09], np.float32), "kl": 0.125}}


@pytest.mark.parametrize("fitted_scale", [False, True])
def test_run_mpc_model_selection_prior_matches_jax(tmp_path, fitted_scale):
    """door-v0's prior from the artifact: the port's run_mpc against JAX's
    build_canonical_agent (the same rule as JAX's run_mpc)."""
    from ppi_tpu.runners.goal_success import build_canonical_agent
    from ppi_tpu_torch.runners import run_mpc
    path = tmp_path / "ms.npz"
    ms.save_model_selection(path, ARTIFACT)
    argv = ["Lbps", "door-v0", "SquaredExponentialKernel", "--horizon", "8",
            "--timesteps", "3", "--device", "cpu", "--model-selection",
            str(path)] + (["--ms-fitted-scale"] if fitted_scale else []) \
        + ["MonteCarlo", "--n-samples", "8"]
    agent, policy = run_mpc.build(run_mpc.build_parser().parse_args(argv))
    cfg = dict(alg="Lbps", policy="SquaredExponentialKernel", horizon=8,
               timesteps=3, n_samples=8, model_selection=str(path),
               ms_fitted_scale=fitted_scale)
    _, _, want = build_canonical_agent("door-v0", cfg)
    np.testing.assert_allclose(to_np(policy.hyper), np.asarray(want.hyper),
                               rtol=1e-6)
    assert float(policy.hyper[1]) == pytest.approx(0.09)
    for field in ("mean_fn", "cov_out", "chol_out"):
        assert _rel(to_np(getattr(policy, field)),
                    np.asarray(getattr(want, field))) <= 1e-6, field
    for field in ("cov_in", "cov_prior"):
        assert _rel(to_np(getattr(policy, field)),
                    np.asarray(getattr(want, field))) <= 1e-5, field
    scaled = np.diagonal(to_np(policy.cov_out)) * 0.7
    box = 0.25 * (2 * np.array([1.5, 1.2, 2.0, 2.0])) ** 2
    if fitted_scale:
        np.testing.assert_allclose(to_np(policy.cov_out),
                                   ARTIFACT["SquaredExponentialKernel"]
                                   ["covariance_out"])
    else:
        np.testing.assert_allclose(scaled, box, rtol=1e-5)
    with pytest.raises(SystemExit, match="no entry for 'Matern32Kernel'"):
        run_mpc.build(run_mpc.build_parser().parse_args(
            [a if a != "SquaredExponentialKernel" else "Matern32Kernel"
             for a in argv]))
