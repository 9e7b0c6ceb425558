"""Multi-start MPC: K solver restarts of one fixed task.

Port of ``ppi_tpu/runners/multi_start.py``. On knife-edge contact tasks
independent solver seeds sample the success band, where more samples make
every temperature-search solver greedier; this runner holds the task (the
env's reset seed, hence any sampled scene) fixed and varies the agent's
seed, reporting each restart's return and the any-success rate. The
restarts run one after another (``utils.batch``), each through the
rollout kernel on the card; ``--mesh-devices W`` splits them over W ranks.
``--device cuda`` (the default) raises without a card.

    python -m ppi_tpu_torch.runners.multi_start --env door-v0 --restarts 5
"""

import argparse
import json
import pathlib
import time

import numpy as np

from ppi_tpu_torch.parallel import make_mesh, spawn
from ppi_tpu_torch.parallel.launch import in_group
from ppi_tpu_torch.runners.goal_success import CONFIGS as GOAL_CONFIGS
from ppi_tpu_torch.runners.goal_success import (
    _device_name, _goal_field, build_canonical_agent, episode, seeds)
from ppi_tpu_torch.utils.batch import chunked_vmap, sharded_vmap

# canonical configs of the tasks without a sampled goal; the goal-sampled
# envs take goal_success.CONFIGS. ``env_kwargs`` pins the nominal scene of
# the hand tasks; drop it to restart over sampled scenes instead
CONFIGS = {
    "door-v0-hand": dict(alg="Lbps", policy="SquaredExponentialKernel",
                         lengthscale="4dt", delta=0.9, n_iters=2, anneal=0.5,
                         timesteps=250, horizon=30, n_samples=64, chunk=1,
                         env_kwargs=dict(fixed_scene=True)),
    "hammer-v0-hand": dict(alg="Lbps", policy="SquaredExponentialKernel",
                           lengthscale="4dt", delta=0.9, n_iters=2,
                           anneal=0.5, timesteps=400, horizon=30,
                           n_samples=128, chunk=1,
                           env_kwargs=dict(fixed_scene=True)),
    "door-v0": dict(alg="Lbps", policy="SquaredExponentialKernel",
                    lengthscale=0.08, delta=0.9, n_iters=2, anneal=0.5,
                    timesteps=250, horizon=30, n_samples=64),
    "hammer-v0": dict(alg="Essps", policy="RffFeatures", lengthscale=0.15,
                      n_elites=10, timesteps=250, horizon=30, n_samples=64),
}


def run(env_name: str, restarts: int, warmstart: int = 50, overrides=None,
        base_key: int = 0, env_key: int = 0, chunk: int = None,
        mesh_devices: int = 0, device="cuda"):
    """K restarts of the canonical config on the task reset with seed
    ``env_key``, restart k seeded with seed k of
    ``goal_success.seeds(base_key)``; returns a JSON-serializable summary
    (``goal``: the task's goal field, which every restart must end with).
    ``chunk`` changes nothing; ``mesh_devices`` as in ``goal_success.run``.
    """
    if mesh_devices and not in_group():
        return spawn(_rank_run, mesh_devices, env_name, restarts, warmstart,
                     overrides, base_key, env_key, mesh_devices,
                     str(device), device=device)
    cfg = dict(CONFIGS.get(env_name) or GOAL_CONFIGS[env_name])
    cfg.update(overrides or {})
    cfg.pop("chunk", None)
    del chunk
    mesh = make_mesh(mesh_devices, device=device) if mesh_devices else None
    env, agent, policy = build_canonical_agent(
        env_name, cfg, device if mesh is None else mesh.device)
    field = _goal_field(env_name)

    def one_restart(key):
        ret, success, _, goal = episode(agent, policy, env_key, int(key),
                                        warmstart, field)
        return ret, success, goal

    keys = seeds(base_key, restarts)
    t0 = time.perf_counter()
    if mesh is not None:
        out = sharded_vmap(one_restart, keys, mesh)
    else:
        out = chunked_vmap(one_restart, keys)
    returns, succ, goals = (x.cpu().numpy() for x in out)
    assert np.array_equal(goals, goals[:1].repeat(restarts, 0)), \
        "every restart must face the task's scene"
    returns = [float(r) for r in returns]
    succ = [bool(s) for s in succ]
    first = next((i for i, s in enumerate(succ) if s), None)
    return {
        "env": env_name, "config": dict(cfg),
        "backend": agent.device.type, "device": _device_name(agent.device),
        "restarts": restarts,
        "success_any": any(succ),
        "n_success": sum(succ),
        "first_success": first,
        "returns": [round(r, 1) for r in returns],
        "best_return": round(max(returns), 1),
        "goal": goals[0].round(4).tolist(),
        "wall_s": round(time.perf_counter() - t0, 1),
    }


def _rank_run(rank, env_name, restarts, warmstart, overrides, base_key,
              env_key, mesh_devices, device):
    """``run`` on one spawned rank."""
    del rank
    return run(env_name, restarts, warmstart, overrides, base_key, env_key,
               mesh_devices=mesh_devices, device=device)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", choices=sorted(set(CONFIGS) | set(GOAL_CONFIGS)),
                   required=True)
    p.add_argument("--restarts", type=int, default=5)
    p.add_argument("--warmstart", type=int, default=50)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="split the restarts over N ranks (spawned here)")
    p.add_argument("--env-key", type=int, default=0)
    p.add_argument("--base-key", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--dir", type=str, default=None)
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VAL",
                   help="override a canonical-config entry (repeatable), "
                        "e.g. --override risk_weight=0.3; VAL is parsed "
                        "as JSON when possible, else kept as a string")
    p.add_argument("--tag", type=str, default=None,
                   help="suffix of the artifact's file name")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.mesh_devices and args.chunk:
        p.error("--mesh-devices and --chunk are mutually exclusive")
    overrides = {}
    for item in args.override:
        key, _, val = item.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    summary = run(args.env, args.restarts, warmstart=args.warmstart,
                  base_key=args.base_key, env_key=args.env_key,
                  chunk=args.chunk, mesh_devices=args.mesh_devices,
                  overrides=overrides, device=args.device)
    print(f"[{args.env}] success {summary['n_success']}/{args.restarts} "
          f"(first at restart {summary['first_success']}), best return "
          f"{summary['best_return']}, {summary['wall_s']} s")
    if args.dir:
        out = pathlib.Path(args.dir)
        out.mkdir(parents=True, exist_ok=True)
        suffix = f"_{args.tag}" if args.tag else ""
        path = out / f"{args.env}_restarts{suffix}.json"
        path.write_text(json.dumps(summary, indent=1) + "\n")
        print(f"wrote {path}")
    return summary


if __name__ == "__main__":
    main()
