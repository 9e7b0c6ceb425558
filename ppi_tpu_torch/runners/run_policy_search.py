"""Episodic policy search runner (torch).

Port of ``ppi_tpu/runners/run_policy_search.py``: positional algorithm +
env + policy, a sampler subcommand, the canonical RBF prior conditioned on
the env's first action, success-rate tracking and npz results, plus
``--device``. The canonical run (``make policy-search``):

    python -m ppi_tpu_torch.runners.run_policy_search Reps BallInACup \\
        RbfFeatures --epsilon 2.0 --n-iters 40 MonteCarlo --n-samples 128

Envs: ``Test`` (sinusoid tracking, no physics) and ``BallInACup``, whose
evaluation on the card is one launch of the ball-in-a-cup kernel an
iteration (``envs/physics/bic_kernel.py``); on the CPU it runs the kernel's
eager plain version, which takes minutes an iteration at the canonical
size. ``--n-string-particles`` builds the sim (and its kernel body) at
another string resolution. ``--track-diagnostics`` records the prior's
entropy each iteration. ``--checkpoint-every K`` writes the policy state
and the generator's state to ``checkpoint.npz`` in ``--dir`` every K
iterations; ``--resume`` continues from it, drawing what the uninterrupted
run would have. ``--mesh-devices W`` shards the trajectories over W ranks
(``parallel.sharded_objective``), which the runner starts (or joins under
``torchrun``); rank 0 alone writes the results. With ``--dir`` the run
writes ``args.json``, its ``log`` and ``data.npz`` (the solver's trace,
``episodes`` and ``success_rate``) under
``<dir>/<algorithm>_<env>_<policy>_<sampling>_<seed>_<name>``.
``--render`` (BallInACup) traces the final prior's mean trajectory (its
derivative channels from ``dfeat``) step by step
(``render.trace_bic_trajectory``) and writes ``ball_in_a_cup.gif`` (in
``--dir``, else the working directory), logging the traced trajectory's
success; ``--plot`` (with ``--dir``) draws the solver's trace
(``result.png``) and 16 samples of the final prior
(``policy_samples.png``).
"""

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch import viz
from ppi_tpu_torch.algorithms import ALGORITHMS, make_solver, solve
from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
from ppi_tpu_torch.envs.episodic import EPISODIC_ENVS
from ppi_tpu_torch.parallel import make_mesh, sharded_objective, spawn
from ppi_tpu_torch.parallel.launch import call_main, in_group
from ppi_tpu_torch.policies import POLICY_NAMES, make_policy
from ppi_tpu_torch.samplers import BY_NAME as SAMPLER_NAMES
from ppi_tpu_torch.utils import (
    checked_device, experiment_dir, load_checkpoint, save_checkpoint,
    save_results, setup_logging, write_args)


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("algorithm", choices=sorted(ALGORITHMS))
    parser.add_argument("env", choices=sorted(EPISODIC_ENVS))
    parser.add_argument("policy", choices=POLICY_NAMES)
    parser.add_argument("--n-iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dir", type=str, default=None)
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--render", action="store_true",
                        help="save a GIF of the learned mean trajectory "
                             "(BallInACup)")
    parser.add_argument("--n-string-particles", type=int, default=0,
                        help="override the ball-in-a-cup string resolution "
                             "(0 = the env's default)")
    parser.add_argument("--track-diagnostics", action="store_true",
                        help="record the matrix-normal prior's entropy")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="save (policy, generator, iteration) every N "
                             "iterations")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the checkpoint in --dir")
    # algorithm hyperparameters
    parser.add_argument("--n-elites", type=int, default=10)
    parser.add_argument("--alpha", type=float, default=0.9)
    parser.add_argument("--epsilon", type=float, default=1.0)
    parser.add_argument("--delta", type=float, default=1.0)
    parser.add_argument("--mesh-devices", type=int, default=0,
                        help="shard the trajectories over this many ranks "
                             "(0 = one process)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the ball-in-a-cup kernel) or cpu (the "
                             "plain versions)")

    sub = parser.add_subparsers(title="sampling", dest="sampling",
                                required=True)
    for samp in sorted(SAMPLER_NAMES):
        sp = sub.add_parser(samp)
        sp.add_argument("--n-samples", type=int, default=10)
    return parser


def make_env(args):
    """The env of ``args``, with the string resolution it names."""
    if args.n_string_particles and args.env == "BallInACup":
        logging.info("BiC string resolution: %d particles",
                     args.n_string_particles)
        return EPISODIC_ENVS[args.env](
            sim=BallInCupSim(n_particles=args.n_string_particles))
    return EPISODIC_ENVS[args.env]()


def setup(args, device):
    """(env, family, policy state, solver) for the parsed arguments on
    ``device``: the canonical prior (RBF features over the episode with
    their derivatives and a bias, input covariance 1e2, output 1e-3 I,
    lengthscale sqrt(3e-2), 20 features), conditioned on the env's first
    action where the env asks for it."""
    env = make_env(args)
    family, policy = make_policy(
        args.policy, env.t, env.dim_action, env.action_0,
        covariance_in=torch.tensor([1e2]),
        covariance_out=torch.diag(torch.tensor([1e-3] * env.dim_action)),
        lengthscale=float(np.sqrt(3e-2)), n_features=20, order=10,
        sampler=args.sampling, use_derivatives=True, add_bias=True,
        track_entropy=args.track_diagnostics, device=device)
    if env.condition:
        policy = family.condition(policy, torch.zeros(1, device=device),
                                  env.action_0.to(device)[None, :])
    # More's entropy schedule is fixed at the JAX runner's values
    # (ppi_tpu/runners/run_policy_search.py passes -200 and 0.99)
    solver = make_solver(args.algorithm, alpha=args.alpha,
                         epsilon=args.epsilon, delta=args.delta,
                         n_elites=args.n_elites, base_entropy=-200.0,
                         entropy_rate=0.99, dimension=family.dim_features)
    return env, family, policy, solver


def search(args, mesh=None):
    """The policy search of ``args`` on ``args.device`` (or, with a
    ``mesh``, the mesh rank's device, the trajectories sharded over it).
    Returns (final policy state, trace as tensors, the
    generator after the last iteration, the first iteration's index)."""
    device = checked_device(args.device if mesh is None else mesh.device)
    env, family, policy, solver = setup(args, device)
    generator = torch.Generator(device).manual_seed(args.seed)
    ckpt = (Path(args.dir) / run_name(args) / "checkpoint.npz"
            if args.dir is not None else None)
    start = 0
    if args.resume and ckpt is not None and ckpt.exists():
        (policy, generator), start = load_checkpoint(ckpt,
                                                     (policy, generator))
        logging.info("resumed from %s at iteration %d", ckpt, start)
    lead = mesh is None or mesh.rank == 0

    def log_and_save(i, f, actions, costs, state):
        if lead:
            logging.info("iter %d: cost %.3f +/- %.3f", start + i,
                         float(torch.mean(costs)),
                         float(torch.std(costs, correction=0)))
            if (args.checkpoint_every and ckpt is not None
                    and (start + i + 1) % args.checkpoint_every == 0):
                save_checkpoint(ckpt, (state, generator),
                                step=start + i + 1)
        return False

    objective = env.objective()
    if mesh is not None:
        objective = sharded_objective(objective, mesh)
    policy, trace = solve(solver, family, policy, objective, generator,
                          args.n_samples, args.n_iters - start,
                          callback=log_and_save)
    return policy, trace, generator, start


def render_mean_trajectory(env, family, policy, out):
    """Trace the prior's mean trajectory (with its derivative channels
    where the family has them) through ``env``'s sim and write its GIF at
    ``out``. Returns (the path written, the mean actions (T, 4), the traced
    qpos and particles, the final ``BicState``)."""
    from ppi_tpu_torch.render import render_ball_in_a_cup, trace_bic_trajectory
    mean_actions = family.predict_mean(policy)
    if family.use_derivatives:
        dxs = family.dfeat(policy, policy.t) @ policy.mean
        mean_actions = torch.cat([mean_actions, dxs], -1)
    qs, qds = env.map_actions_to_joints(mean_actions[None])
    qh, ph, final = trace_bic_trajectory(env.sim, env.q_start, qs[0], qds[0])
    out = render_ball_in_a_cup(env.sim, qh, ph, out, stride=8,
                               device=qs.device)
    return out, mean_actions, qh, ph, final


def run_name(args) -> str:
    return (f"{args.algorithm}_{args.env}_{args.policy}_{args.sampling}_"
            f"{args.seed}_{args.name}")


def main(args, on_trace=None):
    """Run one policy search; returns (final policy state, trace as numpy,
    success-rate history), or None when the result directory already
    holds results. With ``--mesh-devices`` outside a process group it
    starts the ranks and returns rank 0's result. With ``--render``,
    ``on_trace(path, mean actions, qpos, particles, final state)`` sees the
    traced mean trajectory."""
    if args.mesh_devices and not in_group():
        return spawn(call_main, args.mesh_devices, main, args,
                     device=args.device)
    mesh = (make_mesh(args.mesh_devices, device=args.device)
            if args.mesh_devices else None)
    lead = mesh is None or mesh.rank == 0
    filepath = None
    if args.dir is not None:
        # every rank reads the same answer: results are written only after
        # the last iteration, which every rank must reach first
        filepath = experiment_dir(Path(args.dir), run_name(args), args.force)
        if filepath is None:
            print("experiment done!")
            return None
        if lead:
            write_args(args, filepath)
    if lead:
        setup_logging(filepath, args)

    policy, trace, _, start = search(args, mesh)
    trace = {k: v.cpu().numpy() for k, v in trace.items()}
    success_rate = [float(v) for v in trace["success_rate"]]
    if lead:
        logging.info("Success rate history: %s", success_rate)
        if filepath is not None:
            trace["episodes"] = args.n_samples * np.arange(start,
                                                           args.n_iters)
            trace["success_rate"] = np.asarray(success_rate)
            save_results(filepath, **trace)
        if args.render or args.plot:
            env, family, _, _ = setup(args, policy.t.device)
        if args.render and args.env == "BallInACup":
            traced = render_mean_trajectory(
                env, family, policy, (filepath or Path(".")) /
                "ball_in_a_cup.gif")
            _, success = env.sim.reward_and_success(traced[-1])
            logging.info("rendered mean trajectory -> %s (success=%s)",
                         traced[0], bool(success))
            if on_trace is not None:
                on_trace(*traced)
        if args.plot and filepath is not None:
            viz.plot_algorithm_result(trace, filepath / "result",
                                      label=args.algorithm)
            actions, _ = family.sample(
                policy, torch.Generator(policy.t.device).manual_seed(1), 16)
            viz.plot_policy_samples(actions[..., :env.dim_action],
                                    filepath / "policy_samples")
    return policy, trace, success_rate


if __name__ == "__main__":
    main(build_parser().parse_args())
