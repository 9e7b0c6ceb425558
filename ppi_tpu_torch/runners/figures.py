"""Paper-figure generation scripts (torch).

Port of ``ppi_tpu/runners/figures.py``: the explanatory figures from the
port's own stack (Gaussian PPI over Himmelblau, the GP prior under the
receding-horizon shift, draws of the trajectory priors), on ``--device``
(the card unless the caller names another). Random draws come from
``torch.Generator``s seeded where the JAX package seeds its keys.

    python -m ppi_tpu_torch.runners.figures --out /tmp/figures
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch.utils import checked_device
from ppi_tpu_torch.utils.plotting import pyplot as _plt


def _gen(seed, device):
    return torch.Generator(device).manual_seed(seed)


def fig_gaussian_ppi(out: Path, device="cuda"):
    """2-D Gaussian PPI iterations over Himmelblau contours, one panel per
    iteration."""
    from ppi_tpu_torch.algorithms import Batch, make_solver, mask_costs
    from ppi_tpu_torch.envs.functions import Himmelblau
    from ppi_tpu_torch.policies.gaussian import Gaussian

    plt = _plt()
    f = Himmelblau(dim=2)
    fam = Gaussian(dim=2)
    state = fam.init(torch.zeros(2, device=device),
                     9.0 * torch.eye(2, device=device))
    solver = make_solver("Reps", epsilon=1.0)
    xs = np.linspace(-6, 6, 120)
    grid = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2)
    zz = -f(None, torch.as_tensor(grid, dtype=torch.float32)).numpy() \
        .reshape(120, 120)

    gen = _gen(0, device)
    fig, axs = plt.subplots(1, 5, figsize=(22, 4.5))
    for i, ax in enumerate(axs):
        ax.contour(xs, xs, np.log(1.0 + zz - zz.min()), levels=20,
                   cmap="Greys", alpha=0.6)
        samples, params = fam.sample(state, gen, 128)
        # cost = -f (Himmelblau is negated in the suite)
        costs = -f(gen, samples)
        c, v, lv = mask_costs(costs)
        pts = samples.cpu().numpy()
        mu = state.mu.cpu().numpy()
        ax.plot(pts[:, 0], pts[:, 1], ".", alpha=0.4, ms=4)
        ax.plot(float(mu[0]), float(mu[1]), "r*", ms=14)
        ax.set_title(f"iteration {i}")
        ax.set_xlim(-6, 6), ax.set_ylim(-6, 6)
        state, _ = solver.update(fam, state, Batch(c, params, v, lv))
    fig.savefig(out / "gaussian_ppi.png", bbox_inches="tight")
    plt.close(fig)


def fig_gp_shift(out: Path, device="cuda"):
    """GP posterior conditioning under the receding-horizon shift, as
    panels. Returns each panel's (t, mean, std) as numpy."""
    from ppi_tpu_torch.policies import make_policy

    plt = _plt()
    h, dt = 40, 0.05
    t0 = dt * torch.arange(h, device=device)
    fam, state = make_policy(
        "SquaredExponentialKernel", t0, 1, torch.zeros(1), torch.tensor([1.0]),
        torch.eye(1), lengthscale=0.25, device=device)
    state = fam.compute_prior(state, t0)
    # condition mid-horizon and shift the window several times
    state = fam.condition(state, t0[15:16],
                          torch.tensor([[1.2]], device=device))
    fig, axs = plt.subplots(1, 4, figsize=(18, 4), sharey=True)
    panels = []
    for i, ax in enumerate(axs):
        mu, _, _, std = fam.predict(state)
        tt = state.t.cpu().numpy()
        m = mu[:, 0].cpu().numpy()
        s = std[:, 0].cpu().numpy()
        panels.append((tt, m, s))
        ax.plot(tt, m)
        ax.fill_between(tt, m - 2 * s, m + 2 * s, alpha=0.3)
        xs, _ = fam.sample(state, _gen(i, device), 6)
        ax.plot(tt, xs[:, :, 0].cpu().numpy().T, alpha=0.4, lw=0.8)
        ax.set_title(f"shift {i}")
        state = fam.update_timesteps(state, state.t + 5 * dt, anneal=1.0)
    fig.savefig(out / "gp_receding_horizon.png", bbox_inches="tight")
    plt.close(fig)
    return panels


def fig_noise_priors(out: Path, device="cuda"):
    """Sample draws from each trajectory prior family."""
    from ppi_tpu_torch.policies import make_policy

    plt = _plt()
    h = 64
    t = torch.linspace(0, 2, h, device=device)
    families = ["WhiteNoiseIid", "ColouredNoise", "SmoothExplorationNoise",
                "SquaredExponentialKernel", "Matern32Kernel", "PeriodicKernel"]
    fig, axs = plt.subplots(2, 3, figsize=(16, 7))
    for name, ax in zip(families, axs.flat):
        kw = dict(lengthscale=0.3, period=0.5)
        if name == "SmoothExplorationNoise":
            kw["beta"] = 0.3
        fam, state = make_policy(name, t, 1, torch.zeros(1),
                                 torch.tensor([1.0]), torch.eye(1),
                                 device=device, **kw)
        xs, _ = fam.sample(state, _gen(0, device), 8)
        ax.plot(t.cpu().numpy(), xs[:, :, 0].cpu().numpy().T, alpha=0.6,
                lw=1.0)
        ax.set_title(name)
    fig.savefig(out / "trajectory_priors.png", bbox_inches="tight")
    plt.close(fig)


def main(args):
    device = checked_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fig_gaussian_ppi(out, device)
    fig_gp_shift(out, device)
    fig_noise_priors(out, device)
    print(f"figures -> {out}")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="figures")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
