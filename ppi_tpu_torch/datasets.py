"""Offline expert datasets: D4RL-format HDF5 files and npz logs.

Port of ``ppi_tpu/datasets.py``. The model-selection pipeline takes its
expert action windows from D4RL datasets: flat ``actions`` / ``rewards`` /
``terminals`` / ``timeouts`` arrays in a plain HDF5 file, read here with
``h5py`` (no gym or d4rl import chain) and carved into (n_episodes,
horizon, d_a) numpy windows for ``model_selection.select_model``.

Two ways to carve episodes:

* ``episode_length=N``: fixed-length episodes back to back in the flat
  stream (the reference's D4RL ingestion);
* ``episode_length=None``: split on ``terminals | timeouts``. Episodes
  shorter than the horizon are dropped and longer ones truncated, so no
  window reads across an episode boundary.

Everything here is host-side numpy; ``dataset_stats`` computes the FFT
smoothness with the port's torch metric on the CPU.
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ExpertDataset:
    """Windowed expert data: actions (n_episodes, horizon, d_a) and
    rewards (n_episodes, horizon), zeros when the source has none."""

    actions: np.ndarray
    rewards: np.ndarray

    @property
    def n_episodes(self):
        return self.actions.shape[0]

    @property
    def returns(self):
        return self.rewards.sum(axis=1)


def _episode_starts(n, terminals, timeouts, episode_length):
    """Episode start indices (and lengths) in a flat (n, ...) stream."""
    if episode_length is not None:
        return (np.arange(0, n - episode_length + 1, episode_length),
                episode_length)
    done = np.zeros(n, dtype=bool)
    for flags in (terminals, timeouts):
        if flags is not None:
            done |= np.asarray(flags, dtype=bool)
    starts = np.concatenate([[0], np.flatnonzero(done) + 1])
    starts = starts[starts < n]
    return starts, np.diff(np.concatenate([starts, [n]]))


def carve_episodes(actions, rewards=None, terminals=None, timeouts=None,
                   horizon: int = 250, episode_length=1000,
                   max_episodes=None):
    """Carve a flat stream into (n_b, horizon, d_a) action windows (and
    (n_b, horizon) rewards): fixed-length episodes when ``episode_length``
    is an int, split on the done flags when it is None. Episodes shorter
    than ``horizon`` are dropped."""
    actions = np.asarray(actions)
    n = actions.shape[0]
    starts, lengths = _episode_starts(n, terminals, timeouts, episode_length)
    starts = starts[np.broadcast_to(lengths, starts.shape) >= horizon]
    if max_episodes is not None:
        starts = starts[:max_episodes]
    if starts.size == 0:
        raise ValueError(
            f"no episodes of length >= horizon={horizon} in stream of {n} "
            "steps — lower --horizon or check episode_length")
    win_a = np.stack([actions[s:s + horizon] for s in starts])
    if rewards is not None:
        rewards = np.asarray(rewards)
        win_r = np.stack([rewards[s:s + horizon] for s in starts])
    else:
        win_r = np.zeros(win_a.shape[:2], dtype=actions.dtype)
    return ExpertDataset(actions=win_a, rewards=win_r)


def load_d4rl_hdf5(path, horizon: int = 250, episode_length=1000,
                   max_episodes=None, clip_to=None):
    """Load a D4RL-format HDF5 file (``actions`` required; ``rewards``,
    ``terminals``, ``timeouts`` optional) into an :class:`ExpertDataset`.
    ``clip_to=(low, high)`` clips the logged actions first."""
    import h5py

    with h5py.File(path, "r") as f:
        if "actions" not in f:
            raise KeyError(f"{path} has no 'actions' dataset "
                           f"(keys: {sorted(f.keys())})")
        actions = f["actions"][()]
        rewards, terminals, timeouts = (
            f[k][()] if k in f else None
            for k in ("rewards", "terminals", "timeouts"))
    if clip_to is not None:
        actions = np.clip(actions, clip_to[0], clip_to[1])
    return carve_episodes(actions, rewards, terminals, timeouts,
                          horizon=horizon, episode_length=episode_length,
                          max_episodes=max_episodes)


def load_expert_npz(path, horizon: int = 250, max_episodes=None):
    """Load an expert npz log (``actions`` (T, d_a), carved by its
    ``episode_length``, or already (n_b, T, d_a)) into an
    :class:`ExpertDataset`."""
    data = np.load(path)
    actions = np.asarray(data["actions"])
    rewards = np.asarray(data["rewards"]) if "rewards" in data.files else None
    if actions.ndim == 2:
        ep_len = (int(data["episode_length"])
                  if "episode_length" in data.files else actions.shape[0])
        return carve_episodes(actions, rewards, horizon=horizon,
                              episode_length=ep_len,
                              max_episodes=max_episodes)
    if max_episodes is not None:
        actions = actions[:max_episodes]
        rewards = None if rewards is None else rewards[:max_episodes]
    if actions.shape[1] < horizon:
        raise ValueError(f"episodes of length {actions.shape[1]} < "
                         f"horizon {horizon}")
    win_a = actions[:, :horizon]
    win_r = (np.zeros(win_a.shape[:2], dtype=win_a.dtype)
             if rewards is None else rewards[:, :horizon])
    return ExpertDataset(actions=win_a, rewards=win_r)


def dataset_stats(ds: ExpertDataset, dt: float) -> dict:
    """The 25th, 50th and 75th percentiles of the episodes' returns and of
    their actions' FFT smoothness (``mpc.metrics.fft_smoothness``)."""
    from ppi_tpu_torch.mpc.metrics import fft_smoothness
    sm = np.asarray([float(fft_smoothness(torch.as_tensor(a), dt)[0])
                     for a in ds.actions])
    pct = [25, 50, 75]
    return {
        "n_episodes": int(ds.n_episodes),
        "returns_pct": np.percentile(ds.returns, pct).tolist(),
        "smoothness_pct": np.percentile(sm, pct).tolist(),
    }
