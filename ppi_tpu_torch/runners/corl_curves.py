"""Reward and smoothness overlays of the three canonical priors across seeds.

Port of ``ppi_tpu/runners/corl_curves.py``. The paper's MPC claim is that
white-noise sampling is erratic while correlated priors (GP kernels,
random features) succeed with far smoother actions. This runner runs the
three canonical door-v0 prior configurations (Cem + WhiteNoiseIid, Lbps +
SE kernel, Essps + RFF) over N seeds through ``run_mpc`` and writes

  * ``overlay.png``: per-step reward curves (mean over seeds, min/max band)
    and each config's smoothness (``utils.plotting.pyplot``: matplotlib,
    or the PIL stand-in where matplotlib is not installed);
  * ``summary.json`` and each run's ``run_mpc`` artifacts;
  * a table of return, smoothness and success rate per config.

Each config's seeds are checkpointed to ``curves_<label>.json`` as they
finish, and ``--resume`` skips what is recorded. ``--vmap-seeds`` runs a
config's seeds one after another in this process (``utils.batch``) on one
agent, with no per-run artifacts: the same episodes, seed for seed.
``--device cuda`` (the default) raises without a card.

    python -m ppi_tpu_torch.runners.corl_curves --seeds 5
    python -m ppi_tpu_torch.runners.corl_curves --seeds 1 --timesteps 60 \\
        --dir /tmp/corl_smoke
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch.mpc import fft_smoothness, signal_power
from ppi_tpu_torch.runners import run_mpc
from ppi_tpu_torch.utils.batch import chunked_vmap
from ppi_tpu_torch.utils.plotting import pyplot

# the three canonical prior families of the door configs; labels follow the
# paper's terms
CONFIGS = [
    ("iid", "Cem", "WhiteNoiseIid",
     ["--n-elites", "10"]),
    ("gp-se", "Lbps", "SquaredExponentialKernel",
     ["--delta", "0.9", "--n-iters", "2", "--anneal", "0.5",
      "--lengthscale", "0.08"]),
    ("rff", "Essps", "RffFeatures",
     ["--n-elites", "10", "--n-features", "10", "--lengthscale", "0.08",
      "--anneal", "0.5"]),
]


def _config_ckpt(outdir: Path, label: str) -> Path:
    return outdir / f"curves_{label}.json"


def _save_config(outdir: Path, label: str, runs):
    """Persist one config's per-seed curves (the sweep's checkpoint)."""
    payload = [{**r, "rewards": [float(v) for v in r["rewards"]]}
               for r in runs]
    _config_ckpt(outdir, label).write_text(
        json.dumps(payload, indent=1) + "\n")


def _load_config(outdir: Path, label: str):
    p = _config_ckpt(outdir, label)
    if not p.exists():
        return None
    runs = json.loads(p.read_text())
    for r in runs:
        r["rewards"] = np.asarray(r["rewards"], dtype=np.float64)
    return runs


def _argv(alg, env, policy, extra, timesteps, horizon, seed, n_samples,
          device):
    return [alg, env, policy, "--timesteps", str(timesteps), "--horizon",
            str(horizon), "--seed", str(seed), "--device", device, *extra,
            "MonteCarlo", "--n-samples", str(n_samples)]


def _record(seed, rewards, actions, success, dt):
    sm, sm_max, *_ = fft_smoothness(actions, dt)
    return {"seed": seed, "return": float(rewards.sum()),
            "rewards": rewards.double().cpu().numpy(),
            "sm": float(sm), "sm_max": float(sm_max),
            "power": float(signal_power(actions)),
            "success": float(success)}


def run_grid_vmapped(env: str, seeds: int, timesteps: int, horizon: int,
                     n_samples: int, outdir: Path, resume: bool = False,
                     device: str = "cuda", warmstart: int = 50):
    """Each config's seeds through one agent in this process
    (``chunked_vmap``): seed s plans and resets as ``run_mpc --seed s``."""
    results = {}
    for label, alg, policy, extra in CONFIGS:
        if resume:
            done = _load_config(outdir, label)
            if done is not None and len(done) >= seeds:
                print(f"[{label}] resume: {len(done)} seeds already "
                      f"recorded, skipping")
                results[label] = done[:seeds]
                continue
        args = run_mpc.build_parser().parse_args(_argv(
            alg, env, policy, extra, timesteps, horizon, 0, n_samples,
            device))
        agent, pol = run_mpc.build(args)
        dev = agent.device

        def one_seed(seed):
            gen = lambda: torch.Generator(dev).manual_seed(int(seed))
            carry = agent.init(pol, gen())
            state = agent.env.reset(gen(), dev)
            if warmstart:
                carry, _ = agent.warm_start(carry, state, warmstart)
            _, final, track = agent.run_episode(carry, state)
            success = (agent.env.success(final).float()
                       if hasattr(agent.env, "success")
                       else torch.tensor(float("nan"), device=dev))
            return track["reward"], track["action"], success

        rewards, actions, succ = chunked_vmap(one_seed, torch.arange(seeds))
        runs = []
        for i in range(seeds):
            runs.append(_record(i, rewards[i], actions[i], succ[i],
                                agent.env.dt))
            print(f"[{label}] seed {i}: return {runs[-1]['return']:.1f} "
                  f"sm {runs[-1]['sm']:.2f} success {runs[-1]['success']}")
        _save_config(outdir, label, runs)
        results[label] = runs
    return results


def run_grid(env: str, seeds: int, timesteps: int, horizon: int,
             n_samples: int, outdir: Path, resume: bool = False,
             device: str = "cuda"):
    """Each config's seeds as ``run_mpc`` runs, one after another, each with
    its artifacts under ``outdir``."""
    dt, results = run_mpc.ENVS[env]().dt, {}
    for label, alg, policy, extra in CONFIGS:
        runs = []
        if resume:
            runs = (_load_config(outdir, label) or [])[:seeds]
            if runs:
                print(f"[{label}] resume: seeds 0-{len(runs) - 1} already "
                      f"recorded")
        for seed in range(len(runs), seeds):
            argv = _argv(alg, env, policy, extra, timesteps, horizon, seed,
                         n_samples, device)
            argv[3:3] = ["--dir", str(outdir), "--force", "--name", label]
            args = run_mpc.build_parser().parse_args(argv)
            _, success, track = run_mpc.main(args)
            runs.append(_record(seed, track["reward"], track["action"],
                                np.nan if success is None else success, dt))
            print(f"[{label}] seed {seed}: return {runs[-1]['return']:.1f} "
                  f"sm {runs[-1]['sm']:.2f}")
            _save_config(outdir, label, runs)
        results[label] = runs
    return results


def summarize(results):
    """Per config: return and smoothness mean and std over the seeds, the
    success rate (the env's own success test) and the number of seeds."""
    rows = {}
    for label, runs in results.items():
        rets = np.array([r["return"] for r in runs])
        sms = np.array([r["sm"] for r in runs])
        succ = np.array([r["success"] for r in runs])
        rows[label] = {
            "return_mean": float(rets.mean()),
            "return_std": float(rets.std()),
            "smoothness_mean": float(sms.mean()),
            "smoothness_std": float(sms.std()),
            "success_rate": float(np.nanmean(succ))
            if np.isfinite(succ).any() else float("nan"),
            "n_seeds": len(runs),
        }
    return rows


def plot_overlay(results, rows, path: Path):
    """``overlay.png``: the reward curves with a legend and the smoothness
    bars with error bars."""
    plt = pyplot()
    fig, (ax, ax2) = plt.subplots(
        1, 2, figsize=(11, 4), gridspec_kw={"width_ratios": [2.2, 1.0]})
    for i, (label, runs) in enumerate(results.items()):
        curves = np.stack([r["rewards"] for r in runs])  # (seeds, T)
        t = np.arange(curves.shape[1])
        ax.plot(t, curves.mean(0), label=f"{label} "
                f"(ret {rows[label]['return_mean']:.0f}"
                f"±{rows[label]['return_std']:.0f})", color=f"C{i}")
        ax.fill_between(t, curves.min(0), curves.max(0), alpha=0.2,
                        color=f"C{i}")
    ax.set_xlabel("control step")
    ax.set_ylabel("per-step reward")
    ax.legend(fontsize=8)
    ax.set_title("reward curves (mean across seeds, min/max band)")
    labels = list(results)
    ax2.bar(labels, [rows[la]["smoothness_mean"] for la in labels],
            yerr=[rows[la]["smoothness_std"] for la in labels],
            color=[f"C{i}" for i in range(len(labels))])
    ax2.set_ylabel("FFT smoothness Sm (lower = smoother)")
    ax2.set_title("action smoothness")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def main(args):
    outdir = Path(args.dir)
    outdir.mkdir(parents=True, exist_ok=True)
    grid = run_grid_vmapped if args.vmap_seeds else run_grid
    results = grid(args.env, args.seeds, args.timesteps, args.horizon,
                   args.n_samples, outdir, resume=args.resume,
                   device=args.device)
    rows = summarize(results)
    (outdir / "summary.json").write_text(json.dumps(rows, indent=2) + "\n")
    plot_overlay(results, rows, outdir / "overlay.png")
    print(f"\n{'config':8s} {'return':>16s} {'smoothness':>14s}"
          f" {'success':>8s}")
    for label, row in rows.items():
        print(f"{label:8s} {row['return_mean']:9.1f} ± "
              f"{row['return_std']:5.1f} {row['smoothness_mean']:8.2f} ± "
              f"{row['smoothness_std']:4.2f} {row['success_rate']:8.2f}")
    print(f"\nwrote {outdir / 'overlay.png'} and summary.json")
    return rows


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="door-v0", choices=sorted(run_mpc.ENVS))
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--timesteps", type=int, default=250)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--n-samples", type=int, default=64)
    p.add_argument("--vmap-seeds", action="store_true",
                   help="run each config's seeds in this process on one "
                        "agent (no per-run npz artifacts)")
    p.add_argument("--resume", action="store_true",
                   help="skip configs and seeds whose curves_<label>.json "
                        "checkpoint already holds them under --dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--dir", default="results/corl_torch")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
