"""MPC success rate over sampled episode goals and scenes.

Port of ``ppi_tpu/runners/goal_success.py``. pen-v0, relocate-v0 and the
Fetch tasks sample their goal at each reset, door-v0 its frame and
hammer-v0 its board: success on one fixed goal is a weaker claim than
success over the task's distribution. This runner runs N closed-loop MPC
episodes of an env's canonical configuration, each with a fresh reset seed
(a fresh goal), and reports each episode's success and the success rate.
With ``--restarts K`` each sampled task gets K solver seeds, all facing the
same scene, and the summary adds the any-of-K rate.

The JAX package runs the episodes of a chunk as one ``vmap``; the port runs
them one after another (``utils.batch``), one rollout-kernel launch a
planning iteration and a real step on the card. ``--mesh-devices W`` splits
the episodes over W ranks (``parallel.spawn``; gloo where they share a
card), with the same result episode by episode. ``--device cuda`` (the
default) raises without a card.

    python -m ppi_tpu_torch.runners.goal_success --env pen-v0 --resets 5 \\
        --dir results/goals
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.model_selection import fitted_prior
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.parallel import make_mesh, spawn
from ppi_tpu_torch.parallel.launch import in_group
from ppi_tpu_torch.policies import design_moments, make_policy
from ppi_tpu_torch.runners.run_mpc import ENVS
from ppi_tpu_torch.utils import checked_device
from ppi_tpu_torch.utils.batch import chunked_vmap, sharded_vmap

# canonical per-env MPC configurations of the goal- and scene-sampled envs
# (the JAX package's, entry for entry; ``chunk`` is its episodes per
# vmapped call, which the port runs one after another anyway)
CONFIGS = {
    "pen-v0": dict(alg="Lbps", policy="SquaredExponentialKernel",
                   lengthscale=0.08, delta=0.9, n_iters=2, anneal=0.5,
                   timesteps=100, horizon=15, n_samples=96),
    "pen-v0-hand": dict(alg="Lbps", policy="SquaredExponentialKernel",
                        lengthscale=0.08, delta=0.9, n_iters=2, anneal=0.5,
                        timesteps=100, horizon=15, n_samples=96),
    "relocate-v0": dict(alg="Mppi", policy="ColouredNoise", beta=2.0,
                        alpha=10.0, anneal=0.9, timesteps=140, horizon=20,
                        n_samples=256),
    "relocate-v0-hand": dict(alg="Mppi", policy="ColouredNoise", beta=2.0,
                             alpha=10.0, anneal=0.9, timesteps=140,
                             horizon=20, n_samples=256, chunk=1),
    "fetch-push": dict(alg="Mppi", policy="ColouredNoise", beta=2.0,
                       alpha=10.0, anneal=0.9, timesteps=120, horizon=20,
                       n_samples=256),
    "fetch-pick": dict(alg="Mppi", policy="ColouredNoise", beta=2.0,
                       alpha=10.0, anneal=0.9, timesteps=180, horizon=20,
                       n_samples=384),
    "door-v0": dict(alg="Lbps", policy="SquaredExponentialKernel",
                    lengthscale=0.08, delta=0.9, n_iters=2, anneal=0.5,
                    timesteps=250, horizon=30, n_samples=64),
    "hammer-v0": dict(alg="Essps", policy="RffFeatures", lengthscale=0.15,
                      n_elites=10, timesteps=250, horizon=30, n_samples=64),
    "door-v0-hand": dict(alg="Lbps", policy="SquaredExponentialKernel",
                         lengthscale="4dt", delta=0.9, n_iters=2,
                         anneal=0.5, timesteps=250, horizon=30,
                         n_samples=64, chunk=1),
    "hammer-v0-hand": dict(alg="Lbps", policy="SquaredExponentialKernel",
                           lengthscale="4dt", delta=0.9, n_iters=2,
                           anneal=0.5, timesteps=400, horizon=30,
                           n_samples=128, chunk=1),
    "door-v0-adroit": dict(alg="Lbps", policy="SquaredExponentialKernel",
                           lengthscale="4dt", delta=0.9, n_iters=2,
                           anneal=0.5, timesteps=250, horizon=30,
                           n_samples=64, chunk=1),
    "relocate-v0-adroit": dict(alg="Mppi", policy="ColouredNoise", beta=2.0,
                               alpha=10.0, anneal=0.9, timesteps=140,
                               horizon=20, n_samples=256, chunk=1),
    "pen-v0-adroit": dict(alg="Lbps", policy="SquaredExponentialKernel",
                          lengthscale=0.08, delta=0.9, n_iters=2,
                          anneal=0.5, timesteps=100, horizon=15,
                          n_samples=96, chunk=1),
    "hammer-v0-adroit": dict(alg="Lbps", policy="SquaredExponentialKernel",
                             lengthscale="4dt", delta=0.9, n_iters=2,
                             anneal=0.5, timesteps=400, horizon=30,
                             n_samples=128, chunk=1),
}


def build_canonical_agent(env_name, cfg, device="cuda"):
    """(env, agent, initial policy state) on ``device`` from a
    CONFIGS-style dict (``alg``, ``policy``, ``timesteps``, ``horizon``,
    ``n_samples`` and optional hyperparameters). ``lengthscale`` may be
    ``"4dt"``, 4 x env.dt: the resolved value is written back into ``cfg``
    beside ``lengthscale_spec``. ``env_kwargs`` goes to the env (e.g.
    ``fixed_scene``); ``model_selection`` names an artifact whose fitted
    prior replaces the design moments as in ``run_mpc --model-selection``
    (``ms_fitted_scale`` keeps the expert's variance)."""
    device = checked_device(device)
    env = ENVS[env_name](**cfg.get("env_kwargs", {}))
    ls = cfg.get("lengthscale", 1.0)
    if ls == "4dt":
        ls = 4 * env.dt
        cfg["lengthscale_spec"] = "4dt"
        cfg["lengthscale"] = ls
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    if cfg.get("model_selection"):
        mean, cov_in, cov_out, param, _ = fitted_prior(
            cfg["model_selection"], cfg["policy"], env.action_low,
            env.action_high, cfg.get("ms_fitted_scale", False))
        if param.shape[0] > 1:
            ls = float(param[1])
            cfg["lengthscale"] = ls
        if param.shape[0] > 2:
            cfg["period"] = float(param[2])
    family, policy = make_policy(
        cfg["policy"], env.dt * torch.arange(cfg["horizon"]), env.action_dim,
        mean, cov_in, cov_out, lengthscale=ls, beta=cfg.get("beta", 2.0),
        period=cfg.get("period", 1.0), lower=env.action_low,
        upper=env.action_high, device=device)
    solver = make_solver(cfg["alg"], alpha=cfg.get("alpha", 10.0),
                         delta=cfg.get("delta", 0.9),
                         n_elites=cfg.get("n_elites", 10))
    agent = Mpc(env=env, solver=solver, family=family,
                timesteps=cfg["timesteps"], horizon=cfg["horizon"],
                n_samples=cfg["n_samples"], n_iters=cfg.get("n_iters", 1),
                anneal=cfg.get("anneal", 1.0),
                risk_quantile=cfg.get("risk_quantile", 1.0),
                risk_weight=cfg.get("risk_weight", 0.0), device=device)
    return env, agent, policy


def episode(agent, policy, env_seed: int, policy_seed: int,
            warmstart: int, field: str):
    """One closed-loop episode from a reset seeded with ``env_seed`` and
    an agent seeded with ``policy_seed``: (return, success, the goal field
    at the reset, at the end)."""
    env, dev = agent.env, agent.device
    carry = agent.init(policy, torch.Generator(dev).manual_seed(policy_seed))
    state = env.reset(torch.Generator(dev).manual_seed(env_seed), dev)
    if warmstart:
        carry, _ = agent.warm_start(carry, state, n_iters=warmstart)
    _, final, track = agent.run_episode(carry, state)
    return (track["reward"].sum(), env.success(final), getattr(state, field),
            getattr(final, field))


def seeds(base_key: int, n: int) -> torch.Tensor:
    """``n`` int64 seeds drawn from a CPU generator seeded ``base_key``
    (the port's ``jax.random.split(jax.random.key(base_key), n)``)."""
    return torch.randint(2 ** 62, (n,),
                         generator=torch.Generator().manual_seed(base_key))


def run(env_name: str, resets: int, warmstart: int = 50, overrides=None,
        base_key: int = 0, chunk: int = None, mesh_devices: int = 0,
        restarts: int = 1, device="cuda"):
    """The goal sweep; returns a JSON-serializable summary dict.

    Episode (i, k) resets with env seed i of ``seeds(base_key)`` and plans
    with policy seed i * restarts + k of ``seeds(base_key + 1)``: the env
    seed is repeated across a task's ``restarts``, each episode gets a
    fresh policy seed. ``chunk`` is accepted for the JAX package's CLI and
    changes nothing. ``mesh_devices`` > 0 splits the episodes over that
    many ranks (``utils.batch.sharded_vmap``), spawning them when this
    process is in no group; the summary is rank 0's. The summary reports
    the single-start rate (restart 0) and, with ``restarts`` > 1, the
    any-of-K rate."""
    if mesh_devices and not in_group():
        return spawn(_rank_run, mesh_devices, env_name, resets, warmstart,
                     overrides, base_key, mesh_devices, restarts,
                     str(device), device=device)
    cfg = dict(CONFIGS[env_name])
    cfg.update(overrides or {})
    cfg.pop("chunk", None)
    del chunk
    mesh = make_mesh(mesh_devices, device=device) if mesh_devices else None
    env, agent, policy = build_canonical_agent(
        env_name, cfg, device if mesh is None else mesh.device)
    field = _goal_field(env_name)

    def one_episode(key):
        return episode(agent, policy, int(key[0]), int(key[1]), warmstart,
                       field)

    keys = torch.stack([seeds(base_key, resets).repeat_interleave(restarts),
                        seeds(base_key + 1, resets * restarts)], dim=1)
    if mesh is not None:
        out = sharded_vmap(one_episode, keys, mesh)
    else:
        out = chunked_vmap(one_episode, keys)
    returns, succ, goals0, goals_f = (x.cpu().numpy() for x in out)
    assert np.allclose(goals0, goals_f), \
        "episode goal must be constant within an episode"
    returns = returns.reshape(resets, restarts)
    succ = succ.reshape(resets, restarts)
    goals = goals0.reshape(resets, restarts, -1)
    assert np.allclose(goals, goals[:, :1]), \
        "all restarts of a task must face the identical sampled scene"
    goals = goals[:, 0]
    # sampled goals must actually differ across episodes
    spread = float(np.max(np.ptp(goals, axis=0)))
    episodes = [
        {"reset": i, "return": float(returns[i, 0]),
         "success": bool(succ[i, 0]),
         **({"restart_returns": returns[i].round(1).tolist(),
             "restart_successes": succ[i].tolist(),
             "success_any": bool(succ[i].any())} if restarts > 1 else {}),
         "goal": goals[i].round(4).tolist()}
        for i in range(resets)
    ]
    summary = {
        "env": env_name, "config": dict(cfg),
        "backend": agent.device.type, "device": _device_name(agent.device),
        "resets": resets, "goal_spread": round(spread, 4),
        "success_rate": float(np.mean(succ[:, 0].astype(np.float64))),
        "mean_return": float(np.mean(returns[:, 0])),
        "episodes": episodes,
    }
    if restarts > 1:
        summary["restarts"] = restarts
        summary["success_rate_any"] = float(
            np.mean(succ.any(axis=1).astype(np.float64)))
    return summary


def _rank_run(rank, env_name, resets, warmstart, overrides, base_key,
              mesh_devices, restarts, device):
    """``run`` on one spawned rank."""
    del rank
    return run(env_name, resets, warmstart, overrides, base_key,
               mesh_devices=mesh_devices, restarts=restarts, device=device)


def _device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def _goal_field(env_name: str) -> str:
    if env_name.startswith("pen"):
        return "target_axis"
    if env_name.startswith("door"):
        return "frame"   # the sampled scene is the episode's "goal"
    if env_name.startswith("hammer"):
        return "board"
    return "target"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", choices=sorted(CONFIGS), required=True)
    p.add_argument("--resets", type=int, default=5)
    p.add_argument("--warmstart", type=int, default=50)
    p.add_argument("--n-samples", type=int, default=None)
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None)
    p.add_argument("--chunk", type=int, default=None,
                   help="the JAX package's episodes per vmapped call; the "
                        "port runs every episode alone")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="split the episodes over N ranks (spawned here)")
    p.add_argument("--key", type=int, default=0)
    p.add_argument("--restarts", type=int, default=1,
                   help="independent solver seeds per sampled task; the "
                        "summary records single-start and any-of-K rates")
    p.add_argument("--model-selection", type=str, default=None,
                   help="npz from ppi_tpu_torch.model_selection: the "
                        "prior from fitted expert moments")
    p.add_argument("--ms-fitted-scale", action="store_true",
                   help="with --model-selection, keep the expert's action "
                        "variance (no actuator-box rescale)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--dir", type=str, default=None)
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.mesh_devices and args.chunk:
        p.error("--mesh-devices and --chunk are mutually exclusive")
    overrides = {k: getattr(args, k) for k in ("n_samples", "timesteps",
                                               "horizon")
                 if getattr(args, k) is not None}
    if args.model_selection:
        overrides["model_selection"] = args.model_selection
        if args.ms_fitted_scale:
            overrides["ms_fitted_scale"] = True
    summary = run(args.env, args.resets, warmstart=args.warmstart,
                  overrides=overrides, base_key=args.key, chunk=args.chunk,
                  mesh_devices=args.mesh_devices, restarts=args.restarts,
                  device=args.device)
    for ep in summary["episodes"]:
        print(f"[{args.env}] reset {ep['reset']}: return "
              f"{ep['return']:.1f} success {ep['success']}"
              + (f" any-of-{args.restarts} {ep['success_any']}"
                 if args.restarts > 1 else ""))
    print(f"[{args.env}] success rate {summary['success_rate']:.2f} over "
          f"{args.resets} sampled goals (goal spread {summary['goal_spread']})"
          + (f"; any-of-{args.restarts} rate "
             f"{summary['success_rate_any']:.2f}"
             if args.restarts > 1 else ""))
    if args.dir is not None:
        out = Path(args.dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{args.env}_goals.json"
        path.write_text(json.dumps(summary, indent=1) + "\n")
        print(f"wrote {path}")
    return summary


if __name__ == "__main__":
    main()
