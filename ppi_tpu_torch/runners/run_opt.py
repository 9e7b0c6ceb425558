"""Black-box optimization runner (torch).

Port of ``ppi_tpu/runners/run_opt.py`` with the same positional layout and
sampler subcommands (mc / qmc / quad carrying --n-samples), plus
``--device``:

    python -m ppi_tpu_torch.runners.run_opt Reps NoisySphere \\
        --dimension 20 mc --n-samples 100

``--device cuda`` (the default) needs a CUDA card; there every moment match
above the dispatch threshold goes through the hand-written kernel.
``--device cpu`` runs the plain versions. Plots and sharding over several
devices are not ported yet.
"""

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch.algorithms import ALGORITHMS, make_solver, solve
from ppi_tpu_torch.envs.functions import FUNCTIONS, make_function
from ppi_tpu_torch.policies.gaussian import Gaussian
from ppi_tpu_torch.samplers import BY_NAME as SAMPLER_NAMES
from ppi_tpu_torch.utils import (
    experiment_dir, save_results, setup_logging, write_args)

SAMPLER_CHOICES = ["mc", "qmc", "quad", "MonteCarlo", "QuasiMonteCarlo",
                   "CubatureQuadrature"]


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("algorithm", choices=sorted(ALGORITHMS))
    parser.add_argument("function", choices=sorted(FUNCTIONS))
    parser.add_argument("--dimension", type=int, default=5)
    parser.add_argument("--n-iter", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--dir", type=str, default=None)
    parser.add_argument("--force", action="store_true",
                        help="rerun even if results exist")
    # algorithm hyperparameters (union; each solver takes what it declares)
    parser.add_argument("--n-elites", type=int, default=10)
    parser.add_argument("--alpha", type=float, default=0.9)
    parser.add_argument("--base-entropy", type=float, default=-100.0)
    parser.add_argument("--entropy-rate", type=float, default=0.99)
    parser.add_argument("--epsilon", type=float, default=0.1)
    parser.add_argument("--delta", type=float, default=0.5)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the moment-match kernel) or cpu (the "
                             "plain versions)")

    sub = parser.add_subparsers(title="sampling", dest="sampling",
                                required=True)
    for samp in SAMPLER_CHOICES:
        sp = sub.add_parser(samp)
        sp.add_argument("--n-samples", type=int, default=100)
    return parser


def main(args):
    """Run one optimization; returns (final state, trace as numpy), or None
    when the result directory already holds results."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    # f32 everywhere: TF32 matmuls and convolutions off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    filepath = None
    if args.dir is not None:
        name = (f"{args.algorithm}_{args.function}_{args.sampling}_"
                f"{args.seed}_{args.name}")
        filepath = experiment_dir(Path(args.dir), name, args.force)
        if filepath is None:
            print("experiment done!")
            return None
        write_args(args, filepath)
    setup_logging(filepath, args)

    function = make_function(args.function, args.dimension, seed=args.seed)
    # iCEM reuses elites through the Particles sampler (MC + injection)
    sampler = (SAMPLER_NAMES["Particles"] if args.algorithm == "iCem"
               else SAMPLER_NAMES[args.sampling])
    dim = args.dimension
    family = Gaussian(dim=dim, sampler=sampler,
                      diagonal=args.algorithm == "Cem",
                      max_particles=max(1, int(0.33 * args.n_elites)))
    # canonical prior: mu = 1, Sigma = 0.5 I
    state = family.init(torch.ones(dim, device=device),
                        0.5 * torch.eye(dim, device=device))
    solver = make_solver(
        args.algorithm, n_elites=args.n_elites, alpha=args.alpha,
        epsilon=args.epsilon, delta=args.delta, dimension=dim,
        base_entropy=args.base_entropy, entropy_rate=args.entropy_rate)

    n_samples = (2 * dim if args.sampling in ("quad", "CubatureQuadrature")
                 else args.n_samples)
    state, trace = solve(solver, family, state, function,
                         torch.Generator(device).manual_seed(args.seed),
                         n_samples, args.n_iter)
    trace = {k: v.cpu().numpy() for k, v in trace.items()}
    mu = state.mu.cpu().numpy()
    logging.info("final cost %.5g (from %.5g), |mu - x_opt| = %.4g",
                 trace["mean"][-1], trace["mean"][0],
                 float(np.linalg.norm(mu - getattr(function, "x_opt", 0.0))))

    if filepath is not None:
        trace["episodes"] = n_samples * np.arange(args.n_iter)
        save_results(filepath, **trace)
    return state, trace


if __name__ == "__main__":
    main(build_parser().parse_args())
