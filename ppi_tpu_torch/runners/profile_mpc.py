"""MPC profiling harness: ms per steady-state control step.

Port of ``ppi_tpu/runners/profile_mpc.py``: times one MPC control step for
each solver x prior combination (Mppi / iCem / Lbps x SE kernel, white and
coloured noise) at each N, and prints one JSON line. Steps run back to back
with one ``torch.cuda.synchronize()`` at the end (the control loop is a
sequential chain), after one step that builds and warms everything.
``--device cuda`` (the default) raises without a card.

    python -m ppi_tpu_torch.runners.profile_mpc --env door-v0 --runs 10
    python -m ppi_tpu_torch.runners.profile_mpc --combos \\
        Lbps/SquaredExponentialKernel --n-samples 64
"""

import argparse
import json
import time

import torch

from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.policies import design_moments, make_policy
from ppi_tpu_torch.runners.run_mpc import ENVS
from ppi_tpu_torch.utils import checked_device

HORIZON = 30
TIMESTEPS = 250
COMBOS = {
    "Mppi/WhiteNoiseIid": dict(alpha=10.0),
    "Mppi/SquaredExponentialKernel": dict(alpha=10.0),
    "iCem/ColouredNoise": dict(n_elites=10),
    "Lbps/SquaredExponentialKernel": dict(delta=0.1),
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_one(env, policy_name, solver_name, n_samples, runs,
                solver_kwargs=None, device="cuda"):
    """Seconds per control step of one configuration, steps at time
    indices 0-7 in turn (each a window shift)."""
    device = checked_device(device)
    mean, ci, co = design_moments(env.action_low, env.action_high,
                                  ratio=1000.0)
    kw = dict(lower=env.action_low, upper=env.action_high)
    if policy_name == "SquaredExponentialKernel":
        kw["lengthscale"] = 0.05
    fam, pol = make_policy(policy_name, env.dt * torch.arange(HORIZON),
                           env.action_dim, mean, ci, co, device=device, **kw)
    solver = make_solver(solver_name, **(solver_kwargs or {}))
    agent = Mpc(env=env, solver=solver, family=fam, timesteps=TIMESTEPS,
                horizon=HORIZON, n_samples=n_samples, device=device)
    carry = agent.init(pol, torch.Generator(device).manual_seed(0))
    es = env.reset(torch.Generator(device).manual_seed(1), device)
    action, carry, _ = agent.control_step(carry, es, 0)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(runs):
        action, carry, _ = agent.control_step(carry, es, i % 8)
    _sync(device)
    return (time.perf_counter() - t0) / runs


def main(args):
    env = ENVS[args.env]()
    device = checked_device(args.device)
    results = {"env": args.env, "backend": device.type,
               "horizon": HORIZON, "timings_s": {}}
    for n_samples in args.n_samples:
        for combo in args.combos:
            solver_name, policy_name = combo.split("/")
            sec = profile_one(env, policy_name, solver_name, n_samples,
                              args.runs, COMBOS[combo], device)
            key = f"{combo}/n={n_samples}"
            results["timings_s"][key] = round(sec, 5)
            print(f"{key}: {sec * 1e3:.2f} ms/control-step", flush=True)
    print(json.dumps(results))
    return results


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="door-v0", choices=sorted(ENVS))
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--n-samples", type=int, nargs="+",
                   default=[16, 128, 1024])
    p.add_argument("--combos", nargs="+", default=list(COMBOS),
                   choices=list(COMBOS), help="solver/prior pairs to time")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
