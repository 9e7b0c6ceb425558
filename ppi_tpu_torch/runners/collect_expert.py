"""Expert-data collection for the model-selection pipeline.

Port of ``ppi_tpu/runners/collect_expert.py``: run an MPC configuration on
an env and log the executed (obs, action, reward) stream to npz, to be
read by ``model_selection`` (``--expert``) through
``datasets.load_expert_npz`` (either package's reads the other's file).
The keys and dtypes are the JAX runner's: ``observations`` (E T, d_o),
``actions`` (E T, d_a), ``rewards`` (E T,) float32 and ``episode_length``
(the int64 T).

Each episode takes one generator, seeded ``seed + ep``, for the agent and
then the reset (the JAX runner splits ``key(seed + ep)`` the same way, so
their draws differ); a warm start, then ``Mpc.run_episode`` (the JAX
runner's ``run_episode_scan`` is not ported). On the card (``--device
cuda``, the default) every rollout and real step of a kernel env is one
rollout-kernel launch. The defaults are the JAX runner's (Mppi,
ColouredNoise, one iteration), a weak door expert; the canonical config
is ``--algorithm Lbps --policy SquaredExponentialKernel --n-samples 64
--n-iters 2 --anneal 0.5 --warmstart 50``.

    python -m ppi_tpu_torch.runners.collect_expert --env door-v0 \\
        --episodes 3 --out door_expert.npz
"""

import argparse

import numpy as np
import torch

from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.policies import design_moments, make_policy
from ppi_tpu_torch.runners.run_mpc import ENVS
from ppi_tpu_torch.utils import checked_device


def main(args):
    """Collect ``args.episodes`` episodes and write ``args.out``; returns
    the per-episode returns."""
    device = checked_device(args.device)
    env = ENVS[args.env]()
    mean, ci, co = design_moments(env.action_low, env.action_high,
                                  ratio=1000.0)
    fam, pol = make_policy(args.policy, env.dt * torch.arange(args.horizon),
                           env.action_dim, mean, ci, co, beta=2.0,
                           lengthscale=args.lengthscale,
                           lower=env.action_low, upper=env.action_high,
                           device=device)
    agent = Mpc(env=env,
                solver=make_solver(args.algorithm, alpha=5.0, delta=0.9,
                                   n_elites=max(1, args.n_samples // 10)),
                family=fam, timesteps=args.timesteps, horizon=args.horizon,
                n_samples=args.n_samples, n_iters=args.n_iters,
                anneal=args.anneal, device=device)
    all_obs, all_act, all_rew, returns = [], [], [], []
    for ep in range(args.episodes):
        gen = torch.Generator(device).manual_seed(args.seed + ep)
        carry = agent.init(pol, gen)
        es = env.reset(gen, device)
        carry, _ = agent.warm_start(carry, es, n_iters=args.warmstart)
        carry, es, track = agent.run_episode(carry, es)
        all_obs.append(track["obs"].cpu().numpy())
        all_act.append(track["action"].cpu().numpy())
        all_rew.append(track["reward"].cpu().numpy())
        returns.append(float(np.sum(all_rew[-1])))
        print(f"episode {ep}: return {returns[-1]:.2f}", flush=True)
    np.savez(args.out,
             observations=np.concatenate(all_obs),
             actions=np.concatenate(all_act),
             rewards=np.concatenate(all_rew),
             episode_length=np.asarray(args.timesteps))
    print(f"wrote {args.out}")
    return returns


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="door-v0", choices=sorted(ENVS))
    p.add_argument("--policy", default="ColouredNoise")
    p.add_argument("--algorithm", default="Mppi")
    p.add_argument("--lengthscale", type=float, default=0.08)
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--timesteps", type=int, default=250)
    p.add_argument("--horizon", type=int, default=30)
    p.add_argument("--n-samples", type=int, default=128)
    p.add_argument("--n-iters", type=int, default=1)
    p.add_argument("--anneal", type=float, default=1.0)
    p.add_argument("--warmstart", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="expert_data.npz")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
