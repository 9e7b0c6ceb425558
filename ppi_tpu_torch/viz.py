"""Result plotting: optimization traces, policy samples, action sequences,
reward fans, smoothness spectra.

Port of ``ppi_tpu/viz.py`` (which imports no JAX; the port keeps its own
copy): the same eight figures from the same stacked traces. Every array
argument may be a numpy array or a torch tensor (on any device); each is
brought to the host once per call. The plotting module is imported lazily
(``utils.plotting.pyplot``: matplotlib where it is installed, else the
port's PIL stand-in), so a run that makes no plot never pays for it.
"""

import numpy as np
import torch

from ppi_tpu_torch.utils.plotting import pyplot as _plt


def _host(x):
    """A numpy array of ``x`` (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save(fig, filename):
    if filename is not None:
        fig.savefig(f"{filename}.png", bbox_inches="tight")
        _plt().close(fig)


def plot_algorithm_result(trace: dict, filename=None, label=""):
    """One subplot per telemetry channel (log-scale for cost/kl)."""
    plt = _plt()
    trace = {k: _host(v) for k, v in trace.items()}
    keys = [k for k in trace.keys() if trace[k].ndim == 1]
    fig, axs = plt.subplots(1, max(len(keys), 1), figsize=(3 * len(keys), 4))
    axs = np.atleast_1d(axs)
    for ax, k in zip(axs, keys):
        v = trace[k]
        if k in ("mean", "kl") and (v > 0).all():
            ax.set_yscale("log")
        ax.plot(v, label=label or None)
        ax.set_title(k)
        if label:
            ax.legend()
    _save(fig, filename)
    return fig


def plot_mean_std_1d(mean, std, filename=None):
    plt = _plt()
    mean, std = _host(mean), _host(std)
    fig, ax = plt.subplots()
    x = np.arange(mean.shape[0])
    ax.plot(x, mean)
    ax.fill_between(x, mean - std, mean + std, alpha=0.3)
    _save(fig, filename)
    return fig


def plot_policy_samples(actions, filename=None, d_viz=10):
    """Overlay sampled action trajectories, one subplot per action dim.
    ``actions``: (n, H, d_a)."""
    plt = _plt()
    actions = _host(actions)
    d = min(actions.shape[-1], d_viz)
    fig, axs = plt.subplots(d, figsize=(10, 2 * d), squeeze=False)
    for i in range(d):
        axs[i, 0].plot(actions[:, :, i].T, ".-", alpha=0.3)
    _save(fig, filename)
    return fig


def plot_sequence(seq, filename=None, d_viz=None):
    plt = _plt()
    seq = np.atleast_2d(_host(seq))
    if seq.shape[0] == 1:
        seq = seq.T
    d = seq.shape[1] if d_viz is None else min(seq.shape[1], d_viz)
    fig, axs = plt.subplots(d, figsize=(10, 1.5 * d), squeeze=False)
    for i in range(d):
        axs[i, 0].plot(seq[:, i])
    _save(fig, filename)
    return fig


def plot_samples(samples, filename=None):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(_host(samples), alpha=0.3)
    _save(fig, filename)
    return fig


def plot_sequence_history(rewards, reward_history, filename=None):
    """Realized rewards over the per-step planned-reward fan."""
    plt = _plt()
    fig, ax = plt.subplots()
    hist = _host(reward_history)  # (T, N, H)
    if hist.ndim == 3:
        per_step = np.nanmean(hist, axis=2)  # mean planned reward per sample
        ax.plot(per_step, color="C1", alpha=0.05)
    ax.plot(_host(rewards), color="C0", lw=2)
    _save(fig, filename)
    return fig


def plot_smoothness(spectrum, freqs, signal, filename=None):
    plt = _plt()
    fig, axs = plt.subplots(2, figsize=(8, 6))
    axs[0].plot(_host(signal))
    axs[0].set_title("action norm")
    axs[1].plot(_host(freqs), _host(spectrum))
    axs[1].set_title("spectrum")
    _save(fig, filename)
    return fig


def plot_expert_data(data, filename=None, n_episodes=10, d_viz=10,
                     max_steps=250):
    """Expert-dataset inspection: per-episode reward curves + overlaid
    leading action dimensions. ``data`` is a dict/NpzFile with ``actions``
    (T, d_a), ``rewards`` (T,) and optionally ``episode_length`` to split
    the concatenated stream into episodes."""
    plt = _plt()
    act = _host(data["actions"])
    rew = _host(data["rewards"])
    ep_len = int(data["episode_length"]) if "episode_length" in data \
        else rew.shape[0]
    n_eps = max(1, rew.shape[0] // ep_len)
    rew = rew[: n_eps * ep_len].reshape(n_eps, ep_len)
    act = act[: n_eps * ep_len].reshape(n_eps, ep_len, -1)
    d = min(d_viz, act.shape[-1])
    fig, axs = plt.subplots(1 + d, figsize=(8, 1.2 * (1 + d)), sharex=True)
    axs = np.atleast_1d(axs)
    axs[0].plot(rew[:n_episodes].T)
    axs[0].set_ylabel("reward")
    for i in range(d):
        axs[1 + i].plot(act[: min(5, n_eps), :max_steps, i].T, alpha=0.3)
        axs[1 + i].set_ylabel(f"a[{i}]")
    axs[-1].set_xlabel("step")
    _save(fig, filename)
    return fig


if __name__ == "__main__":
    # `python -m ppi_tpu_torch.viz expert.npz [out]`: the view_data CLI
    import sys as _sys

    _data = np.load(_sys.argv[1])
    _out = _sys.argv[2] if len(_sys.argv) > 2 else None
    plot_expert_data(_data, _out)
    if _out is None:
        _plt().show()
