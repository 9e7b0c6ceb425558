"""Animated paper figures (torch).

Port of ``ppi_tpu/runners/animations.py``: four GIFs built on the port's
own machinery. The temperatures come from the port's solvers and scalar
searches (``ops.bisect_decreasing``, ``ops.golden_section_min``), the
weights and moments from ``ops``, and the GP shift and resolution
animations drive the real ``BaseKernel.update_timesteps`` and kernel
cross-covariance; ``_fit_tracking_gp`` fits its prior with ``solve``.
Everything runs on ``--device`` (the card unless the caller names
another); random draws come from ``torch.Generator``s seeded where the
JAX package seeds its keys.

    python -m ppi_tpu_torch.runners.animations --out figures/ [--which X]
"""

import argparse
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch.utils import checked_device
from ppi_tpu_torch.utils.plotting import pyplot
from ppi_tpu_torch.utils.video import save_gif


def _gif(path, frames, fps=20):
    return save_gif(Path(path), frames, fps=fps)


def _rasterize(fig):
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    pyplot().close(fig)
    return buf


def anim_gaussian_ppi(out: Path, n_frames: int = 40, device="cuda"):
    """Gaussian prior -> Gibbs posterior as the temperature alpha anneals
    (a Laplace-form posterior on a quadratic cost; closed form, numpy)."""
    plt = pyplot()
    x = np.linspace(-10, 10, 600)
    mu_c, sigma2_c = 5.0, 0.5          # quadratic cost centre/curvature
    mu0, sigma0 = -5.0, 1.0
    pdf = lambda m, s: np.exp(-0.5 * ((x - m) / s) ** 2) / (
        s * np.sqrt(2 * np.pi))
    frames = []
    for alpha in np.linspace(0.0, 3.0, n_frames):
        s2 = 1.0 / (1.0 / sigma0 ** 2 + alpha / sigma2_c)
        m = mu0 - alpha * s2 * (mu0 - mu_c) / sigma2_c
        fig, ax = plt.subplots(figsize=(7, 3))
        axf = ax.twinx()
        axf.plot(x, -0.5 * (x - mu_c) ** 2 / sigma2_c, "k-", lw=1)
        ax.plot(x, pdf(mu0, sigma0), "b", label="prior $p$")
        ax.fill_between(x, pdf(mu0, sigma0), color="b", alpha=0.2)
        ax.plot(x, pdf(m, np.sqrt(s2)), "c",
                label=r"posterior $q_\alpha$")
        ax.fill_between(x, pdf(m, np.sqrt(s2)), color="c", alpha=0.2)
        ax.set_ylim(0, 4)
        ax.set_title(f"alpha = {alpha:.2f}")
        ax.legend(loc="upper right")
        frames.append(_rasterize(fig))
    return _gif(out / "gaussian_ppi.gif", frames)


def anim_nonlinear_ppi(out: Path, n_frames_per: int = 8, device="cuda"):
    """CEM / ESSPS / LBPS importance weights and the moment-matched next
    prior on a multimodal reward; the temperatures from the port's scalar
    searches."""
    from ppi_tpu_torch import ops

    plt = pyplot()
    x = np.linspace(-10, 10, 600)
    mu_r, sigma2_r = 5.0, 2.0
    reward = lambda z: (np.exp(-0.5 * (z - mu_r) ** 2 / sigma2_r)
                        * np.abs(np.sin(6 * z)) - 1.0)
    rng = np.random.default_rng(0)
    samples = rng.normal(0.0, 1.0, size=128)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=device)
    costs = f32(-reward(samples))
    pts = f32(samples)[:, None]
    pdf = lambda m, s: np.exp(-0.5 * ((x - m) / s) ** 2) / (
        s * np.sqrt(2 * np.pi))

    def posterior_from(log_w):
        mu, sig, ess = ops.m_projection(log_w, pts, "never")
        return float(mu[0]), float(torch.sqrt(sig[0, 0])), float(ess)

    def host(log_w):
        return log_w.cpu().numpy()

    panels = []
    # CEM elite weighting over shrinking elite sets
    for k in np.linspace(64, 8, n_frames_per).astype(int):
        thresh = torch.sort(costs).values[k - 1]
        log_w = torch.where(costs <= thresh, 0.0, -1e12)
        panels.append((f"CEM, k={int(k)}", "g", host(log_w),
                       posterior_from(log_w)))
    # ESSPS: temperature matched to a target effective sample size
    cn = (costs - costs.min()) / (costs.max() - costs.min() + 1e-9)

    def ess_of(a):
        lw = -a * cn
        nw = lw - torch.logsumexp(lw, 0)
        return torch.exp(-torch.logsumexp(2 * nw, 0))

    for ess_target in np.linspace(64, 4, n_frames_per):
        alpha = float(ops.bisect_decreasing(ess_of, float(ess_target),
                                            1e-3, 1e3, device=device))
        log_w = -alpha * cn
        panels.append((f"ESSPS, ESS*={ess_target:.0f}", "c", host(log_w),
                       posterior_from(log_w)))
    # LBPS: concentration-bound-minimizing temperature per delta
    for delta in np.linspace(0.5, 0.99, n_frames_per):
        lam = float(np.sqrt((1 - delta) / delta))

        def bound(a, lam=lam):
            lw = -a * cn
            nw = lw - torch.logsumexp(lw, 0)
            ess = torch.exp(-torch.logsumexp(2 * nw, 0))
            return torch.sum(torch.exp(nw) * cn) + lam / torch.sqrt(ess)

        alpha = float(ops.golden_section_min(bound, 1e-3, 1e3, iters=60,
                                             device=device))
        log_w = -alpha * cn
        panels.append((f"LBPS, delta={delta:.2f}", "m", host(log_w),
                       posterior_from(log_w)))

    prior_pdf = pdf(0.0, 1.0)
    frames = []
    for title, color, log_w, (m, s, ess) in panels:
        nw = np.exp(log_w - log_w.max())
        nw = nw / nw.sum()
        fig, ax = plt.subplots(figsize=(7, 3))
        axf = ax.twinx()
        axf.plot(x, reward(x), "k-", lw=1)
        axf.set_ylim(-1.05, 0.1)
        ax.plot(x, prior_pdf, "b", label="prior $p$")
        ax.fill_between(x, prior_pdf, color="b", alpha=0.15)
        ax.vlines(samples, 0, 3.0 * nw, color="r", alpha=0.25)
        ax.plot(x, pdf(m, max(s, 1e-2)), color=color,
                label=r"next prior $q_\alpha \to p$")
        ax.fill_between(x, pdf(m, max(s, 1e-2)), color=color, alpha=0.2)
        ax.set_ylim(0, 3)
        ax.set_title(f"{title}   (ESS = {ess:.1f})")
        ax.legend(loc="upper left")
        frames.append(_rasterize(fig))
    return _gif(out / "nonlinear_ppi.gif", frames, fps=2)


def _fit_tracking_gp(horizon=30, dt=1.0 / 30.0, n_iters=40, n_samples=256,
                     device="cuda"):
    """CEM-fit an SE-kernel GP policy to a square-wave tracking task."""
    from ppi_tpu_torch.algorithms import make_solver, solve
    from ppi_tpu_torch.policies import make_policy

    t = dt * torch.arange(horizon, device=device)
    u_d = lambda tau: 1.0 * (torch.cos(2 * np.pi * tau) > 0.0)
    target = u_d(t)[:, None]

    fam, pol = make_policy(
        "SquaredExponentialKernel", t, 1,
        mean=torch.tensor([0.5]), covariance_in=torch.tensor([1e2]),
        covariance_out=0.5 * torch.tensor([[1e-2]]), lengthscale=0.2,
        lower=torch.tensor([0.0]), upper=torch.tensor([1.0]), device=device)

    def cost(generator, actions):
        return torch.sum(torch.abs(actions - target[None]), dim=(1, 2))

    solver = make_solver("Cem", n_elites=n_samples // 10)
    pol, _ = solve(solver, fam, pol, cost,
                   torch.Generator(device).manual_seed(0), n_samples,
                   n_iters)
    return fam, pol, t, dt, u_d


def anim_policy_time_shift(out: Path, n_frames: int = 24, device="cuda"):
    """The receding-horizon GP conditioning shift, animated: the fitted
    posterior slides along time via ``update_timesteps`` and fresh samples
    stay consistent with the conditioned window."""
    plt = pyplot()
    fam, pol, t, dt, u_d = _fit_tracking_gp(device=device)
    horizon = t.shape[0]
    t_long = dt * np.arange(2 * horizon)
    frames = []
    state = pol
    gen = torch.Generator(device).manual_seed(1)
    for i in range(n_frames):
        t_new = dt * torch.arange(i, i + horizon, device=device)
        state = fam.update_timesteps(state, t_new, anneal=1.0)
        samp, _ = fam.sample(state, gen, 8)
        mean = fam.predict_mean(state)
        fig, ax = plt.subplots(figsize=(7, 3))
        ax.plot(t_long, u_d(torch.as_tensor(t_long)).numpy(), "k--", lw=1)
        tn = t_new.cpu().numpy()
        ax.plot(tn, samp[:, :, 0].cpu().numpy().T, "c-", alpha=0.4)
        ax.plot(tn, mean[:, 0].cpu().numpy(), "b.-")
        ax.set_xlim(float(t_long[0]) - dt, float(t_long[-1]) + dt)
        ax.set_ylim(-0.4, 1.4)
        ax.set_title(f"GP window shift: t in [{float(tn[0]):.2f}, "
                     f"{float(tn[-1]):.2f}]")
        frames.append(_rasterize(fig))
    return _gif(out / "policy_time_shift.gif", frames, fps=8)


def anim_policy_time_resolution(out: Path, n_frames: int = 24,
                                device="cuda"):
    """The function-space prior evaluated at increasingly fine time
    resolution: kernel policies predict at any grid through the prior
    cross-covariance."""
    plt = pyplot()
    fam, pol, t, dt, u_d = _fit_tracking_gp(device=device)
    frames = []
    n = t.shape[0]
    for n_res in np.linspace(8, 240, n_frames).astype(int):
        t_res = torch.linspace(float(t[0]), float(t[-1]), int(n_res),
                               device=device)
        # posterior mean on the new grid through the cross-covariance
        k_xt = fam.k(pol, t_res, pol.t)
        sol = torch.linalg.solve(pol.cov_prior + 1e-8 * torch.eye(
            n, device=device), pol.mean)
        mean_res = pol.mean_fn[None, :] + k_xt @ sol
        fig, ax = plt.subplots(figsize=(7, 3))
        ax.plot(t.cpu().numpy(), u_d(t).cpu().numpy(), "k--", lw=1)
        ax.plot(t_res.cpu().numpy(), mean_res[:, 0].cpu().numpy(), "b.-",
                ms=3)
        ax.set_ylim(-0.4, 1.4)
        ax.set_title(f"GP prediction at {int(n_res)} points "
                     f"(fitted on {n})")
        frames.append(_rasterize(fig))
    return _gif(out / "policy_time_resolution.gif", frames, fps=8)


ANIMATIONS = {
    "gaussian_ppi": anim_gaussian_ppi,
    "nonlinear_ppi": anim_nonlinear_ppi,
    "policy_time_shift": anim_policy_time_shift,
    "policy_time_resolution": anim_policy_time_resolution,
}


def main(args):
    device = checked_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    which = ANIMATIONS if args.which == "all" else {
        args.which: ANIMATIONS[args.which]}
    paths = []
    for name, fn in which.items():
        path = fn(out, device=device)
        paths.append(path)
        print(f"wrote {path}")
    return paths


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="figures")
    p.add_argument("--which", default="all",
                   choices=["all"] + sorted(ANIMATIONS))
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
