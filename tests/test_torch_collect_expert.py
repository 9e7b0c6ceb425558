"""``runners/collect_expert.py`` against the JAX package's runner.

The two runners draw different random numbers, so their episodes differ;
what must agree is the file: the same keys, dtypes and layout, each
package's ``load_expert_npz`` reading the other's file to the same
arrays, and the flags and defaults of the JAX runner (plus ``--device``).
Pendulum (no kernel in either package) at a small size; door-v0 on the
CPU through the plain rollout at T=3.
"""

import argparse

import numpy as np
import pytest

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu import datasets as jax_datasets
from ppi_tpu.runners import collect_expert as jax_collect
from ppi_tpu_torch import datasets
from ppi_tpu_torch.runners import collect_expert

SMALL = dict(env="pendulum", policy="ColouredNoise", algorithm="Mppi",
             lengthscale=0.08, episodes=2, timesteps=20, horizon=8,
             n_samples=16, n_iters=1, anneal=1.0, warmstart=2, seed=0)


def _port(tmp_path, **kw):
    cfg = {**SMALL, **kw}
    out = tmp_path / f"port_{cfg['env']}.npz"
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in cfg.items()]
    args = collect_expert.build_parser().parse_args(
        argv + ["--device", "cpu", "--out", str(out)])
    return collect_expert.main(args), out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert")
    jax_out = tmp / "jax.npz"
    jax_collect.main(argparse.Namespace(**SMALL, out=str(jax_out)))
    returns, port_out = _port(tmp)
    return jax_out, port_out, returns


def test_npz_has_the_reference_layout(files):
    jax_out, port_out, returns = files
    ref, got = np.load(jax_out), np.load(port_out)
    assert sorted(got.files) == sorted(ref.files) == [
        "actions", "episode_length", "observations", "rewards"]
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].shape == ref[k].shape, k
    assert int(got["episode_length"]) == SMALL["timesteps"]
    assert got["actions"].shape == (2 * SMALL["timesteps"], 1)
    assert len(returns) == 2 and np.isfinite(returns).all()
    np.testing.assert_allclose(
        returns, got["rewards"].reshape(2, -1).sum(1), rtol=1e-5)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_both_loaders_read_both_files(files, which):
    path = files[0] if which == "jax" else files[1]
    ref = jax_datasets.load_expert_npz(path, horizon=8)
    got = datasets.load_expert_npz(path, horizon=8)
    np.testing.assert_array_equal(got.actions, np.asarray(ref.actions))
    np.testing.assert_array_equal(got.rewards, np.asarray(ref.rewards))
    assert got.actions.shape[1:] == (8, 1)


def test_flags_and_defaults_match_the_reference():
    args = collect_expert.build_parser().parse_args([])
    assert (args.env, args.policy, args.algorithm, args.lengthscale,
            args.episodes, args.timesteps, args.horizon, args.n_samples,
            args.n_iters, args.anneal, args.warmstart, args.seed,
            args.out) == ("door-v0", "ColouredNoise", "Mppi", 0.08, 3, 250,
                          30, 128, 1, 1.0, 30, 0, "expert_data.npz")
    assert args.device == "cuda"


def test_door_episode_on_the_cpu(tmp_path):
    """The canonical solver and prior at a tiny size: the kernel env's
    plain rollout and observations in the file."""
    returns, out = _port(tmp_path, env="door-v0", algorithm="Lbps",
                         policy="SquaredExponentialKernel", episodes=1,
                         timesteps=3, horizon=4, n_samples=8, n_iters=2,
                         anneal=0.5, warmstart=1)
    data = np.load(out)
    assert data["actions"].shape == (3, 4)
    assert data["observations"].shape[0] == 3
    assert np.isfinite(data["observations"]).all() and np.isfinite(returns)
