"""The port's expert-dataset ingestion (``ppi_tpu_torch.datasets``) against
``ppi_tpu.datasets``: ``tests/test_datasets.py``'s cases, each run through
both packages on the HDF5 and npz files the test writes. Both are numpy on
the host, so their outputs are equal exactly; the smoothness percentiles
(torch's FFT against XLA's) within 1e-5."""

import numpy as np
import pytest

import ppi_tpu.datasets as jax_ds
import ppi_tpu_torch.datasets as ds

h5py = pytest.importorskip("h5py")


def _write_d4rl(path, n_steps=400, d_a=3, ep_len=100, seed=0):
    rng = np.random.default_rng(seed)
    actions = rng.normal(size=(n_steps, d_a)).astype(np.float32)
    rewards = rng.uniform(size=n_steps).astype(np.float32)
    timeouts = np.zeros(n_steps, dtype=bool)
    timeouts[ep_len - 1::ep_len] = True
    with h5py.File(path, "w") as f:
        f["actions"] = actions
        f["rewards"] = rewards
        f["terminals"] = np.zeros(n_steps, dtype=bool)
        f["timeouts"] = timeouts
    return actions, rewards


def _same(got, want):
    assert type(got).__name__ == type(want).__name__ == "ExpertDataset"
    np.testing.assert_array_equal(got.actions, want.actions)
    np.testing.assert_array_equal(got.rewards, want.rewards)
    assert got.actions.dtype == want.actions.dtype
    assert got.rewards.dtype == want.rewards.dtype
    assert got.n_episodes == want.n_episodes
    np.testing.assert_array_equal(got.returns, want.returns)


def test_fixed_length_carving_matches_jax(tmp_path):
    path = tmp_path / "d.hdf5"
    actions, rewards = _write_d4rl(path, n_steps=400, ep_len=100)
    got = ds.load_d4rl_hdf5(path, horizon=40, episode_length=100)
    _same(got, jax_ds.load_d4rl_hdf5(path, horizon=40, episode_length=100))
    assert got.actions.shape == (4, 40, 3) and got.rewards.shape == (4, 40)
    for i in range(4):
        np.testing.assert_array_equal(got.actions[i],
                                      actions[100 * i:100 * i + 40])
        np.testing.assert_array_equal(got.rewards[i],
                                      rewards[100 * i:100 * i + 40])


def test_done_flag_carving_drops_short_episodes(tmp_path):
    path = tmp_path / "d.hdf5"
    actions = np.random.default_rng(1).normal(size=(250, 2)).astype(
        np.float32)
    terminals = np.zeros(250, dtype=bool)
    terminals[119] = terminals[149] = True   # [0,120) [120,150) [150,250)
    with h5py.File(path, "w") as f:
        f["actions"] = actions
        f["terminals"] = terminals
    got = ds.load_d4rl_hdf5(path, horizon=60, episode_length=None)
    _same(got, jax_ds.load_d4rl_hdf5(path, horizon=60, episode_length=None))
    assert got.actions.shape == (2, 60, 2)
    np.testing.assert_array_equal(got.actions[1], actions[150:210])
    assert float(np.abs(got.rewards).sum()) == 0.0


def test_clip_to_and_max_episodes_match_jax(tmp_path):
    path = tmp_path / "d.hdf5"
    _write_d4rl(path, n_steps=400, ep_len=100, seed=2)
    kw = dict(horizon=50, episode_length=100, clip_to=(-0.5, 0.5),
              max_episodes=2)
    got = ds.load_d4rl_hdf5(path, **kw)
    _same(got, jax_ds.load_d4rl_hdf5(path, **kw))
    assert got.n_episodes == 2
    assert float(np.max(np.abs(got.actions))) <= 0.5


@pytest.mark.parametrize("package", [ds, jax_ds], ids=["torch", "jax"])
def test_errors_are_jax_s(tmp_path, package):
    with pytest.raises(ValueError, match="no episodes of length"):
        package.carve_episodes(np.zeros((30, 2)), horizon=60,
                               episode_length=None)
    with h5py.File(tmp_path / "bad.hdf5", "w") as f:
        f["observations"] = np.zeros((10, 2))
    with pytest.raises(KeyError, match="no 'actions' dataset"):
        package.load_d4rl_hdf5(tmp_path / "bad.hdf5")
    np.savez(tmp_path / "short.npz", actions=np.zeros((2, 10, 2)))
    with pytest.raises(ValueError, match="< horizon"):
        package.load_expert_npz(tmp_path / "short.npz", horizon=20)


def test_npz_and_stats_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "e.npz",
             actions=rng.normal(size=(300, 2)).astype(np.float32),
             rewards=rng.uniform(size=300).astype(np.float32),
             episode_length=np.asarray(100))
    got = ds.load_expert_npz(tmp_path / "e.npz", horizon=80)
    _same(got, jax_ds.load_expert_npz(tmp_path / "e.npz", horizon=80))
    assert got.actions.shape == (3, 80, 2)
    stats = ds.dataset_stats(got, dt=0.02)
    want = jax_ds.dataset_stats(got, dt=0.02)
    assert stats["n_episodes"] == want["n_episodes"] == 3
    np.testing.assert_allclose(stats["returns_pct"], want["returns_pct"],
                               rtol=1e-6)
    np.testing.assert_allclose(stats["smoothness_pct"],
                               want["smoothness_pct"], rtol=1e-5)
    s = stats["smoothness_pct"]
    assert s[0] <= s[1] <= s[2]
    # pre-windowed (n_b, T, d_a) logs
    np.savez(tmp_path / "w.npz", actions=got.actions)
    _same(ds.load_expert_npz(tmp_path / "w.npz", horizon=50,
                             max_episodes=2),
          jax_ds.load_expert_npz(tmp_path / "w.npz", horizon=50,
                                 max_episodes=2))


def test_d4rl_feeds_model_selection_end_to_end(tmp_path):
    """The ingested windows drive the port's moment and kernel-KL pipeline
    (``select_model`` takes pre-windowed (n_b, H, d_a) batches)."""
    from ppi_tpu_torch.model_selection import default_kernels, select_model
    path = tmp_path / "d.hdf5"
    t = np.arange(600) * 0.05
    base = np.stack([np.sin(0.7 * t), np.cos(1.3 * t)], axis=1)
    with h5py.File(path, "w") as f:
        f["actions"] = (base + 0.05 * np.random.default_rng(4).normal(
            size=base.shape)).astype(np.float32)
        f["rewards"] = np.zeros(600, dtype=np.float32)
    data = ds.load_d4rl_hdf5(path, horizon=24, episode_length=60)
    assert data.n_episodes == 10
    out = select_model(data.actions, 24, {"SquaredExponentialKernel":
                       default_kernels(0.05)["SquaredExponentialKernel"]},
                       t=0.05 * np.arange(24), device="cpu")
    entry = out["SquaredExponentialKernel"]
    assert entry["mean"].shape == (2,)
    assert entry["covariance_out"].shape == (2, 2)
    assert np.isfinite(entry["kl"]) and np.all(entry["param"] > 0)


def test_expert_dataset_properties():
    data = ds.ExpertDataset(actions=np.zeros((5, 10, 2)),
                            rewards=np.ones((5, 10)))
    assert data.n_episodes == 5
    np.testing.assert_allclose(data.returns, 10.0)
