"""Experiment grids over the native sweep executor.

Port of ``ppi_tpu/runners/run_sweep.py``: builds a runner's canonical grid
(algorithms x seeds) of the port's runners and runs it through
``ppi-sweep`` (``utils.sweep``: a bounded process pool, per-job logs,
retries, a JSONL summary). Every command runs on ``--device`` (the card by
default).

    python -m ppi_tpu_torch.runners.run_sweep --runner opt --seeds 3 -j 2 \\
        --dir results/sweep_torch
"""

import argparse
import sys
from pathlib import Path

from ppi_tpu_torch.utils.sweep import run_sweep

GRIDS = {
    "opt": [
        "{py} -m ppi_tpu_torch.runners.run_opt {alg} NoisySphere "
        "--dimension 20 --seed {seed} --dir {dir} --device {device} mc "
        "--n-samples 100",
        ["Reps", "Mppi", "Lbps", "Essps", "Cem"],
    ],
    "policy-search": [
        "{py} -m ppi_tpu_torch.runners.run_policy_search {alg} BallInACup "
        "RbfFeatures --epsilon 2.0 --n-iters 40 --seed {seed} --dir {dir} "
        "--device {device} MonteCarlo --n-samples 128",
        ["Reps", "Essps", "Lbps"],
    ],
    "mpc": [
        "{py} -m ppi_tpu_torch.runners.run_mpc {alg} door-v0 "
        "SquaredExponentialKernel --delta 0.9 --anneal 0.5 "
        "--lengthscale 0.08 --alpha 5.0 --seed {seed} --dir {dir} "
        "--device {device} MonteCarlo --n-samples 64",
        ["Lbps", "Mppi"],
    ],
}


def main(args):
    template, algorithms = GRIDS[args.runner]
    out = Path(args.dir)
    out.mkdir(parents=True, exist_ok=True)
    commands = [
        template.format(py=sys.executable, alg=alg, seed=seed, dir=out,
                        device=args.device)
        for alg in algorithms for seed in range(args.seeds)
    ]
    rows, code = run_sweep(commands, n_workers=args.jobs,
                           retries=args.retries, workdir=out,
                           logdir=out / "logs")
    ok = sum(1 for r in rows if r["exit"] == 0)
    print(f"sweep: {ok}/{len(rows)} jobs succeeded "
          f"(summary: {out / 'sweep_summary.jsonl'})")
    return code


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runner", choices=sorted(GRIDS), default="opt")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--jobs", "-j", type=int, default=2)
    p.add_argument("--retries", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="each command's --device (cuda, the default, or "
                        "cpu)")
    p.add_argument("--dir", default="results/sweep_torch")
    return p


if __name__ == "__main__":
    raise SystemExit(main(build_parser().parse_args()))
