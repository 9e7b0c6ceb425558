"""Offline prior fitting (model selection).

Port of ``ppi_tpu/model_selection.py``:

  1. ``extract_matrix_normal_moments`` fits a matrix-normal distribution to
     windows of expert actions by the flip-flop MLE (``ops.m_projection_mavn``,
     5 iterations, the column covariance re-estimated too);
  2. ``fit_kernel_hyperparams`` fits a kernel's hyperparameters so that its
     Gram matches the fitted input covariance in Gaussian KL: a fixed Adam
     loop over log-hyper, gradients from ``torch.autograd``.

``select_model`` runs both for each kernel family and returns the artifact
that ``run_mpc --model-selection`` and ``goal_success``'s canonical agent
read (``fitted_prior``). The npz layout is the JAX package's, so each
package reads the other's file:

    python -m ppi_tpu_torch.model_selection --expert data.npz \\
        --horizon 30 --dt 0.04 --out model_selection.npz
    python -m ppi_tpu_torch.model_selection --d4rl door-human.hdf5 ...

``--kernels`` fits only the named families (default: all four).
``--device cuda`` (the default) fits on the card and raises without one.
"""

import argparse
import math

import numpy as np
import torch

from ppi_tpu_torch import ops
from ppi_tpu_torch.policies.kernels import (
    k_matern32, k_matern52, k_periodic, k_squared_exponential)
from ppi_tpu_torch.utils import checked_device


def action_windows(actions: torch.Tensor, horizon: int, stride: int = 1):
    """Slice an expert action log (T, d_a) into (N, horizon, d_a) windows."""
    starts = range(0, actions.shape[0] - horizon + 1, stride)
    return torch.stack([actions[s:s + horizon] for s in starts])


def extract_matrix_normal_moments(windows: torch.Tensor,
                                  iterations: int = 5):
    """Unweighted matrix-normal MLE over expert action windows: (mean (H,
    d_a), covariance_in (H, H), covariance_out (d_a, d_a))."""
    n, h, d_a = windows.shape
    eye = lambda d: torch.eye(d, dtype=windows.dtype, device=windows.device)
    mean, cov_in, cov_out, _ = ops.m_projection_mavn(
        torch.zeros(n, dtype=windows.dtype, device=windows.device), windows,
        eye(h), eye(d_a), iterations=iterations, update_out=True)
    return mean, cov_in, cov_out


def fit_kernel_hyperparams(kernel_fn, t, target_cov, hyper0,
                           lr: float = 0.05, steps: int = 1500):
    """Minimize KL( N(0, target) || N(0, K_hyper(t, t)) ) over log-hyper
    with ``steps`` Adam steps (0.9, 0.999, 1e-8; a non-finite gradient
    taken as 0). ``kernel_fn(hyper, t1, t2)`` is a Gram function of
    ``policies.kernels``. Returns (hyper, the KL of the last step)."""
    zero = torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    x = torch.log(hyper0)
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    kl = None
    for i in range(steps):
        x_ = x.detach().requires_grad_(True)
        kl = ops.multivariate_gaussian_kl(zero, target_cov, zero,
                                          kernel_fn(torch.exp(x_), t, t))
        g, = torch.autograd.grad(kl, x_)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9 ** (i + 1))
        vhat = v / (1.0 - 0.999 ** (i + 1))
        x = x - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return torch.exp(x), kl.detach()


def default_kernels(dt: float) -> dict:
    """The kernel families fitted by default, keyed by policy name (what
    ``run_mpc --model-selection`` looks up): {name: (Gram function, initial
    hyperparameters)}."""
    ls0 = 5.0 * dt
    return {
        "SquaredExponentialKernel": (k_squared_exponential, (1.0, ls0)),
        "Matern32Kernel": (k_matern32, (1.0, ls0)),
        "Matern52Kernel": (k_matern52, (1.0, ls0)),
        "PeriodicKernel": (k_periodic, (1.0, ls0, 20.0 * dt)),
    }


def select_model(expert_actions, horizon: int, kernels: dict, t=None,
                 device="cuda"):
    """Expert actions -> matrix-normal moments -> the least-KL
    hyperparameters of each kernel family, on ``device``.

    ``expert_actions``: a (T, d_a) log, cut into every ``horizon`` window,
    or pre-windowed (n_b, >= horizon, d_a) episodes (``datasets``).
    Returns {name: {mean (d_a,), covariance_out, param, kl}}."""
    device = checked_device(device)
    x = torch.as_tensor(np.asarray(expert_actions), dtype=torch.float32,
                        device=device)
    windows = x[:, :horizon] if x.dim() == 3 else action_windows(x, horizon)
    mean, cov_in, cov_out = extract_matrix_normal_moments(windows)
    t = (torch.arange(horizon, dtype=torch.float32) if t is None
         else torch.as_tensor(np.asarray(t), dtype=torch.float32)).to(device)
    out = {}
    for name, (kernel_fn, hyper0) in kernels.items():
        hyper, kl = fit_kernel_hyperparams(
            kernel_fn, t, cov_in,
            torch.tensor(hyper0, dtype=torch.float32, device=device))
        out[name] = {
            "mean": mean.mean(dim=0).cpu().numpy(),
            "covariance_out": cov_out.cpu().numpy(),
            "param": hyper.cpu().numpy(),
            "kl": float(kl),
        }
    return out


def save_model_selection(path, payload: dict):
    """Write a {policy_name: {mean, covariance_out, param, kl}} payload as
    npz, one pickled dict an entry (the JAX package's layout)."""
    np.savez(path, **{name: np.asarray(entry, dtype=object)
                      for name, entry in payload.items()})


def load_model_selection(path) -> dict:
    data = np.load(path, allow_pickle=True)
    return {name: data[name].item() for name in data.files}


def fitted_prior(path, policy: str, action_low, action_high,
                 fitted_scale: bool = False):
    """The prior moments of ``policy``'s entry in a model-selection
    artifact: (mean (d_a,), kernel variance (1,), covariance_out, param,
    kl). The fitted input covariance's kernel parameters (variance,
    lengthscale, period) and the output correlation are kept; unless
    ``fitted_scale``, the output covariance is rescaled so each action's
    variance is the actuator box's exploration scale 0.25 (high - low)^2
    (a converged expert's variance is far too small to explore from)."""
    payload = load_model_selection(path)
    if policy not in payload:
        raise SystemExit(f"--model-selection artifact has no entry for "
                         f"{policy!r}; available: {sorted(payload)}")
    entry = payload[policy]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    param = np.asarray(entry["param"])
    cov_in, cov_out = f32(param[:1]), f32(entry["covariance_out"])
    if not fitted_scale:
        design_var = 0.25 * (f32(action_high) - f32(action_low)) ** 2
        fitted_var = cov_in[0] * torch.diagonal(cov_out)
        d = torch.sqrt(design_var / torch.clamp(fitted_var, min=1e-12))
        cov_out = cov_out * torch.outer(d, d)
    return (f32(entry["mean"]), cov_in, cov_out, param,
            float(entry.get("kl", math.nan)))


def main(args):
    dt = float(args.dt)
    if args.d4rl:
        from ppi_tpu_torch.datasets import dataset_stats, load_d4rl_hdf5
        ds = load_d4rl_hdf5(
            args.d4rl, horizon=args.horizon,
            episode_length=(args.episode_length or None),
            max_episodes=args.max_episodes)
        stats = dataset_stats(ds, dt)
        print(f"d4rl: {stats['n_episodes']} episodes, "
              f"returns pct25/50/75 = {np.round(stats['returns_pct'], 2)}, "
              f"smoothness = {np.round(stats['smoothness_pct'], 3)}")
        actions = ds.actions
    else:
        actions = np.load(args.expert)["actions"]
    t = dt * torch.arange(args.horizon, dtype=torch.float32)
    kernels = {name: entry for name, entry in default_kernels(dt).items()
               if name in args.kernels}
    payload = select_model(actions, args.horizon, kernels, t=t,
                           device=args.device)
    for name, entry in payload.items():
        print(f"{name}: param={np.round(entry['param'], 4)} "
              f"kl={entry['kl']:.4f}")
    save_model_selection(args.out, payload)
    print(f"wrote {args.out}")
    return payload


def build_parser():
    p = argparse.ArgumentParser(
        description="Fit matrix-normal moments and kernel hyperparameters "
                    "to expert action data.")
    p.add_argument("--expert",
                   help="npz with an 'actions' (T, d_a) array")
    p.add_argument("--d4rl",
                   help="D4RL-format HDF5 dataset (actions/rewards/"
                        "terminals/timeouts), read with h5py")
    p.add_argument("--episode-length", type=int, default=1000,
                   help="fixed episode length in the flat stream; 0 = "
                        "split on terminals/timeouts instead")
    p.add_argument("--max-episodes", type=int, default=None)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--dt", type=float, default=0.02)
    p.add_argument("--out", default="model_selection.npz")
    p.add_argument("--kernels", nargs="+", default=list(default_kernels(1.0)),
                   choices=list(default_kernels(1.0)),
                   help="the kernel families to fit (default: all four)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


if __name__ == "__main__":
    _p = build_parser()
    _args = _p.parse_args()
    if not (_args.expert or _args.d4rl):
        _p.error("one of --expert / --d4rl is required")
    main(_args)
