"""MPC experiment runner (torch).

The part of ``ppi_tpu/runners/run_mpc.py`` that the ported envs and
priors use, with the same positional layout plus ``--device``:

    python -m ppi_tpu_torch.runners.run_mpc Lbps door-v0 \\
        SquaredExponentialKernel --delta 0.9 --n-iters 2 --anneal 0.5 \\
        --lengthscale 0.08 MonteCarlo --n-samples 64
    python -m ppi_tpu_torch.runners.run_mpc Mppi relocate-v0 \\
        ColouredNoise --beta 2 --alpha 10 --anneal 0.9 --timesteps 140 \\
        --horizon 20 MonteCarlo --n-samples 256
    python -m ppi_tpu_torch.runners.run_mpc Lbps door-v0-hand \\
        SquaredExponentialKernel --delta 0.9 --n-iters 2 --anneal 0.5 \\
        --lengthscale 0.08 MonteCarlo --n-samples 64
    python -m ppi_tpu_torch.runners.run_mpc Essps hammer-v0 RffFeatures \\
        --n-elites 10 --lengthscale 0.15 MonteCarlo --n-samples 64

Envs: door-v0, door-v0-hand, door-v0-adroit, pen-v0, pen-v0-hand,
relocate-v0, relocate-v0-hand, hammer-v0, hammer-v0-hand, cheetah;
``--lengthscale 0.08`` is the hand scenes' canonical "4dt". Every prior of
the JAX package's registry runs; ``--n-features`` and ``--order`` size the
RBF and RFF bases, and RBF features span the episode while every other
prior spans the horizon. ``--alpha``, ``--epsilon``, ``--n-elites``,
``--delta`` and ``--beta`` go to the solver and the prior as in the JAX
runner; iCem samples with particle reuse and acts on the MAP sequence.
``--device cuda`` (the default) needs a CUDA card and rolls out through
the hand-written kernel (the real env step of the hand and hammer scenes
too); ``--device cpu`` runs the eager plain version. Plots, rendering,
checkpoints, model selection, ``--optimize-prior`` and the risk flags are
not ported yet.
"""

import argparse
import logging
import time

import torch

from ppi_tpu_torch.algorithms import ALGORITHMS, make_solver
from ppi_tpu_torch.envs.cheetah import Cheetah
from ppi_tpu_torch.envs.door import Door
from ppi_tpu_torch.envs.door_adroit import DoorAdroit
from ppi_tpu_torch.envs.door_hand import DoorHand
from ppi_tpu_torch.envs.hammer import Hammer
from ppi_tpu_torch.envs.hammer_hand import HammerHand
from ppi_tpu_torch.envs.pen import Pen
from ppi_tpu_torch.envs.pen_hand import PenHand
from ppi_tpu_torch.envs.relocate import Relocate
from ppi_tpu_torch.envs.relocate_hand import RelocateHand
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.policies import POLICY_NAMES, design_moments, make_policy
from ppi_tpu_torch.samplers import BY_NAME as SAMPLER_NAMES

ENVS = {"door-v0": Door, "door-v0-hand": DoorHand,
        "door-v0-adroit": DoorAdroit, "pen-v0": Pen, "pen-v0-hand": PenHand,
        "relocate-v0": Relocate, "relocate-v0-hand": RelocateHand,
        "hammer-v0": Hammer, "hammer-v0-hand": HammerHand,
        "cheetah": Cheetah}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("algorithm", choices=sorted(ALGORITHMS))
    parser.add_argument("env", choices=sorted(ENVS))
    parser.add_argument("policy", choices=POLICY_NAMES)
    parser.add_argument("--timesteps", type=int, default=250)
    parser.add_argument("--horizon", type=int, default=30)
    parser.add_argument("--n-warmstart-iters", type=int, default=50)
    parser.add_argument("--n-iters", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--anneal", type=float, default=1.0)
    # algorithm hyperparameters (the JAX runner's defaults)
    parser.add_argument("--n-elites", type=int, default=10)
    parser.add_argument("--alpha", type=float, default=10.0)
    parser.add_argument("--epsilon", type=float, default=2.0)
    parser.add_argument("--delta", type=float, default=0.9)
    # policy hyperparameters
    parser.add_argument("--beta", type=float, default=2.0)
    parser.add_argument("--lengthscale", type=float, default=1.0)
    parser.add_argument("--n-features", type=int, default=10)
    parser.add_argument("--order", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the rollout kernel) or cpu (the eager "
                             "plain version)")
    sub = parser.add_subparsers(title="sampling", dest="sampling",
                                required=True)
    for samp in sorted(SAMPLER_NAMES):
        sp = sub.add_parser(samp)
        sp.add_argument("--n-samples", type=int, default=64)
    return parser


def setup(args):
    """(agent, carry, env_state) for the parsed arguments: the env, prior,
    solver and agent on ``args.device``, the carry and the reset state both
    seeded with ``args.seed``."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    # f32 everywhere: TF32 matmuls and convolutions off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    env = ENVS[args.env]()
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    use_particles = args.algorithm == "iCem"
    # RBF features span the whole episode; everything else the horizon
    span = args.timesteps if args.policy == "RbfFeatures" else args.horizon
    family, policy = make_policy(
        args.policy, env.dt * torch.arange(span), env.action_dim,
        mean, cov_in, cov_out, lengthscale=args.lengthscale, period=env.dt,
        n_features=args.n_features, order=args.order,
        sampler="Particles" if use_particles else args.sampling,
        beta=args.beta, lower=env.action_low, upper=env.action_high,
        max_particles=max(1, int(0.33 * args.n_elites)), device=device)
    solver = make_solver(args.algorithm, alpha=args.alpha,
                         epsilon=args.epsilon, delta=args.delta,
                         n_elites=args.n_elites,
                         dimension=family.dim_features)
    if args.n_samples < family.dim_features:
        # fewer samples than weight dimensions: the fitted input covariance
        # is rank-deficient, the PD guard reverts every update (the mean
        # included), and the episode degenerates to the prior mean
        logging.warning(
            "n_samples=%d < dim_features=%d: the moment-matched covariance "
            "cannot be PD, so every posterior update will be reverted. "
            "Increase --n-samples or reduce --n-features/--horizon.",
            args.n_samples, family.dim_features)
    agent = Mpc(env=env, solver=solver, family=family,
                timesteps=args.timesteps, horizon=args.horizon,
                n_samples=args.n_samples, n_iters=args.n_iters,
                anneal=args.anneal, use_map=use_particles, device=device)
    carry = agent.init(policy,
                       torch.Generator(device).manual_seed(args.seed))
    env_state = env.reset(torch.Generator(device).manual_seed(args.seed),
                          device)
    return agent, carry, env_state


def main(args, callback=None):
    """Run one episode; returns (return, success, track); success is None
    for an env without a success test (cheetah). ``callback(t, env_state,
    row)`` sees every control step (``Mpc.run_episode``)."""
    logging.basicConfig(
        format="%(asctime)s,%(msecs)d %(name)s %(levelname)s %(message)s",
        datefmt="%H:%M:%S", level=logging.INFO, force=True)
    for k, v in sorted(vars(args).items()):
        logging.info("%s: %s", k, v)
    agent, carry, env_state = setup(args)
    env, device = agent.env, agent.device

    t0 = time.perf_counter()
    if args.n_warmstart_iters > 0:
        carry, wtrace = agent.warm_start(carry, env_state,
                                         args.n_warmstart_iters)
        logging.info("Warm start: %.2f +/- %.2f",
                     float(wtrace["mean"][-1]), float(wtrace["std"][-1]))
    carry, env_state, track = agent.run_episode(carry, env_state, callback)
    ret = float(track["reward"].sum())
    logging.info("Return: %.2f over %d timesteps", ret, args.timesteps)
    success = None
    if hasattr(env, "success"):
        success = bool(env.success(env_state))
        logging.info("Success: %s", success)
    logging.info("Episode wall time: %.2f s (%s)", time.perf_counter() - t0,
                 device)
    return ret, success, track


if __name__ == "__main__":
    main(build_parser().parse_args())
