"""The port's MPC runner: its results on disk, its control-quality metrics
and the rollout kernel's body cache, on the CPU.

``fft_smoothness`` and ``signal_power`` are held to the JAX package's on
the same numpy signal (1e-5). A run with ``--dir`` writes ``args.json``,
``log`` and a ``data.npz`` with the JAX runner's keys; a second run there
stops unless ``--force``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
from ppi_tpu.mpc import fft_smoothness as jax_fft_smoothness
from ppi_tpu.mpc import signal_power as jax_signal_power
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.mpc import fft_smoothness, signal_power
from ppi_tpu_torch.runners import run_mpc

# ppi_tpu/runners/run_mpc.py's save_results keys
NPZ_KEYS = {"obs", "actions", "rewards", "ess", "alphas", "sm", "sm_max",
            "power", "success", "action_signal"}


@pytest.mark.parametrize("n", [9, 40])
def test_metrics_match_reference(n):
    acts = np.random.default_rng(n).standard_normal((n, 3)).astype(
        np.float32)
    got = fft_smoothness(to_torch(acts), 0.02)
    ref = jax_fft_smoothness(jnp.asarray(acts), 0.02)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(float(signal_power(to_torch(acts))),
                               float(jax_signal_power(jnp.asarray(acts))),
                               rtol=1e-5)


def _argv(tmp_path, *extra):
    return ["Mppi", "reacher", "WhiteNoiseIid", "--timesteps", "3",
            "--horizon", "3", "--n-warmstart-iters", "1", "--dir",
            str(tmp_path), "--name", "x", *extra, "--device", "cpu",
            "MonteCarlo", "--n-samples", "6"]


def test_results_directory_and_exists_guard(tmp_path, capsys):
    args = run_mpc.build_parser().parse_args(_argv(tmp_path))
    ret, success, track = run_mpc.main(args)
    out = tmp_path / "Mppi_reacher_WhiteNoiseIid_MonteCarlo_6_0_x"
    saved = json.loads((out / "args.json").read_text())
    assert saved["env"] == "reacher" and saved["risk_weight"] == 0.0
    assert (out / "log").read_text().count("Smoothness:") == 1
    data = np.load(out / "data.npz")
    assert set(data.files) == NPZ_KEYS
    np.testing.assert_array_equal(data["actions"], to_np(track["action"]))
    np.testing.assert_array_equal(data["rewards"], to_np(track["reward"]))
    assert data["obs"].shape == (3, 10) and data["ess"].shape == (3,)
    assert np.isnan(data["success"]) and success is None
    assert np.isclose(data["rewards"].sum(), ret)
    sm, sm_max, _, _, signal = fft_smoothness(track["action"], 0.02)
    assert float(data["sm"]) == float(sm)
    assert float(data["sm_max"]) == float(sm_max)
    np.testing.assert_array_equal(data["action_signal"], to_np(signal))
    assert float(data["power"]) == float(signal_power(track["action"]))
    # the episode track carries the coordinates
    assert track["qpos"].shape == (3, 2)

    stamp = (out / "data.npz").stat().st_mtime_ns
    capsys.readouterr()
    assert run_mpc.main(run_mpc.build_parser().parse_args(
        _argv(tmp_path))) is None
    assert "experiment done!" in capsys.readouterr().out
    assert (out / "data.npz").stat().st_mtime_ns == stamp
    again = run_mpc.main(run_mpc.build_parser().parse_args(
        _argv(tmp_path, "--force")))
    assert again is not None and np.isclose(again[0], ret)


def test_risk_flags_reach_the_agent(monkeypatch):
    args = run_mpc.build_parser().parse_args(
        ["Mppi", "reacher", "WhiteNoiseIid", "--risk-weight", "0.5",
         "--device", "cpu", "MonteCarlo"])
    assert args.risk_quantile == 0.25 and args.risk_weight == 0.5
    agent, _, _ = run_mpc.setup(args)
    assert agent.risk_quantile == 0.25 and agent.risk_weight == 0.5
    default = run_mpc.build_parser().parse_args(
        ["Mppi", "reacher", "WhiteNoiseIid", "MonteCarlo"])
    assert default.risk_weight == 0.0


def test_the_header_cache_holds_every_registered_body():
    """Generating every kernel env's body twice misses the cache once per
    env: none is evicted."""
    bodies = []
    for name, cls in sorted(run_mpc.KERNEL_ENVS.items()):
        env = cls()
        assert rk.supports_kernel(env), name
        state = env.reset(torch.Generator().manual_seed(0), "cpu")
        bodies.append(rk.body_args(env, state))
    assert len(bodies) == 21
    rk._env_header.cache_clear()
    for _ in range(2):
        for args in bodies:
            rk._env_header(*args)
    info = rk._env_header.cache_info()
    assert info.misses == len(bodies) and info.hits == len(bodies)
