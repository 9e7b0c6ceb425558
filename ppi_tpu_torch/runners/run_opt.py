"""Black-box optimization runner (torch).

Port of ``ppi_tpu/runners/run_opt.py`` with the same positional layout and
sampler subcommands (mc / qmc / quad carrying --n-samples), plus
``--device``:

    python -m ppi_tpu_torch.runners.run_opt Reps NoisySphere \\
        --dimension 20 mc --n-samples 100

``--device cuda`` (the default) needs a CUDA card; there every moment match
above the dispatch threshold goes through the hand-written kernel.
``--device cpu`` runs the plain versions. ``--mesh-devices W`` shards the
sample axis of the evaluation over W ranks (``parallel.sharded_objective``):
the runner starts them (``parallel.launch.spawn``; on one card they share
it over gloo) or, started under ``torchrun``, joins the launcher's group;
every rank holds a replica of the solver and the generator, and rank 0
alone writes ``args.json``, the ``log`` and ``data.npz``. The sharded run
equals the unsharded one bit for bit. ``--plot`` draws the solver's
trace (``viz.plot_algorithm_result``; ``result.png`` with ``--dir``).
"""

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch import viz
from ppi_tpu_torch.algorithms import ALGORITHMS, make_solver, solve
from ppi_tpu_torch.envs.functions import FUNCTIONS, make_function
from ppi_tpu_torch.parallel import make_mesh, sharded_objective, spawn
from ppi_tpu_torch.parallel.launch import call_main, in_group
from ppi_tpu_torch.policies.gaussian import Gaussian
from ppi_tpu_torch.samplers import BY_NAME as SAMPLER_NAMES
from ppi_tpu_torch.utils import (
    checked_device, experiment_dir, save_results, setup_logging, write_args)

SAMPLER_CHOICES = ["mc", "qmc", "quad", "MonteCarlo", "QuasiMonteCarlo",
                   "CubatureQuadrature"]


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("algorithm", choices=sorted(ALGORITHMS))
    parser.add_argument("function", choices=sorted(FUNCTIONS))
    parser.add_argument("--dimension", type=int, default=5)
    parser.add_argument("--n-iter", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--plot", action="store_true")
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
    parser.add_argument("--mesh-devices", type=int, default=0,
                        help="shard the sample axis over this many ranks "
                             "(0 = one process)")

    sub = parser.add_subparsers(title="sampling", dest="sampling",
                                required=True)
    for samp in SAMPLER_CHOICES:
        sp = sub.add_parser(samp)
        sp.add_argument("--n-samples", type=int, default=100)
    return parser


def optimize(args, mesh=None):
    """The optimization of ``args`` on ``args.device`` (or, with a
    ``mesh``, the mesh rank's device, the evaluation sharded over it);
    returns (final state, trace as tensors, the generator after the
    last iteration)."""
    device = checked_device(args.device if mesh is None else mesh.device)
    function = make_function(args.function, args.dimension, seed=args.seed)
    objective = (function if mesh is None
                 else sharded_objective(function, mesh))
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
    generator = torch.Generator(device).manual_seed(args.seed)
    state, trace = solve(solver, family, state, objective, generator,
                         n_samples(args), args.n_iter)
    return state, trace, generator


def n_samples(args) -> int:
    """The batch size: 2 d sigma points for the cubature sampler."""
    return (2 * args.dimension
            if args.sampling in ("quad", "CubatureQuadrature")
            else args.n_samples)


def main(args):
    """Run one optimization; returns (final state, trace as numpy), or None
    when the result directory already holds results. With
    ``--mesh-devices`` outside a process group it starts the ranks and
    returns rank 0's result."""
    mesh_devices = getattr(args, "mesh_devices", 0)
    if mesh_devices and not in_group():
        return spawn(call_main, mesh_devices, main, args,
                     device=args.device)
    mesh = make_mesh(mesh_devices, device=args.device) if mesh_devices \
        else None
    lead = mesh is None or mesh.rank == 0
    filepath = None
    if args.dir is not None:
        name = (f"{args.algorithm}_{args.function}_{args.sampling}_"
                f"{args.seed}_{args.name}")
        # every rank reads the same answer: results are written only after
        # the last iteration, which every rank must reach first
        filepath = experiment_dir(Path(args.dir), name, args.force)
        if filepath is None:
            print("experiment done!")
            return None
        if lead:
            write_args(args, filepath)
    if lead:
        setup_logging(filepath, args)

    state, trace, _ = optimize(args, mesh)
    trace = {k: v.cpu().numpy() for k, v in trace.items()}
    if lead:
        function = make_function(args.function, args.dimension,
                                 seed=args.seed)
        mu = state.mu.cpu().numpy()
        logging.info(
            "final cost %.5g (from %.5g), |mu - x_opt| = %.4g",
            trace["mean"][-1], trace["mean"][0],
            float(np.linalg.norm(mu - getattr(function, "x_opt", 0.0))))
        if filepath is not None:
            trace["episodes"] = n_samples(args) * np.arange(args.n_iter)
            save_results(filepath, **trace)
        if args.plot:
            viz.plot_algorithm_result(
                trace, filepath / "result" if filepath else None,
                label=args.algorithm)
    return state, trace


if __name__ == "__main__":
    main(build_parser().parse_args())
