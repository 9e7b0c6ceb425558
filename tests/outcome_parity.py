"""Episode outcomes of the JAX package and the port from the same pinned
states, on the CPU: does a task that fails in the port fail in JAX too?

    PYTHONPATH=. python tests/outcome_parity.py reacher-sweep
    PYTHONPATH=. python tests/outcome_parity.py reacher QPOS QVEL TARGET \
        [SEEDS]
    PYTHONPATH=. python tests/outcome_parity.py fetch-push QPOS QVEL \
        TARGET [SEEDS]

``reacher-sweep``: JAX's reacher at its own sampled targets (reset keys
0-9), the canonical config of ``tests/test_envs.py:36-48`` (Mppi,
WhiteNoiseIid, alpha 5, N=64, H=20, T=80) after 50 warm-start iterations;
prints each target's norm and the final fingertip distance. The other
two run both packages from the state given as JSON lists (the port's
episode through ``run_mpc.setup``, JAX's through ``goal_success.
build_canonical_agent``), agent seeds 0..SEEDS-1 (3), at the canonical
configs (fetch-push: ``goal_success.py:41-43``); prints the return and
the fingertip distance or the success. The two packages draw different
random numbers, so outcomes are compared, not bits. Not collected by
pytest (a study: minutes on the CPU).
"""

import dataclasses
import json
import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ppi_tpu.runners.goal_success import build_canonical_agent
from ppi_tpu_torch.runners import run_mpc

jax.config.update("jax_platforms", "cpu")

CONFIGS = {
    "reacher": dict(alg="Mppi", policy="WhiteNoiseIid", alpha=5.0,
                    timesteps=80, horizon=20, n_samples=64),
    "fetch-push": dict(alg="Mppi", policy="ColouredNoise", beta=2.0,
                       alpha=10.0, anneal=0.9, timesteps=120, horizon=20,
                       n_samples=256),
}
PORT_ARGS = {
    "reacher": ["Mppi", "reacher", "WhiteNoiseIid", "--alpha", "5",
                "--timesteps", "80", "--horizon", "20"],
    "fetch-push": ["Mppi", "fetch-push", "ColouredNoise", "--beta", "2",
                   "--alpha", "10", "--anneal", "0.9", "--timesteps", "120",
                   "--horizon", "20"],
}


def _outcome(name, env, state, ret):
    if name == "reacher":
        tip = np.asarray(env.fingertip(state.physics.qpos))
        return {"return": round(float(ret), 2), "dist": round(float(
            np.linalg.norm(tip - np.asarray(state.target))), 4)}
    return {"return": round(float(ret), 2),
            "success": bool(env.success(state))}


def jax_episode(name, state_fn, seed):
    env, agent, pol = build_canonical_agent(name, dict(CONFIGS[name]))
    s = state_fn(env)
    carry = agent.init(pol, jax.random.key(seed))
    carry, _ = agent.warm_start(carry, s, 50)
    _, final, track = agent.run_episode_scan(carry, s, collect=False)
    return s, _outcome(name, env, final, np.asarray(track["reward"]).sum())


def port_episode(name, qpos, qvel, target, seed):
    args = run_mpc.build_parser().parse_args(
        PORT_ARGS[name] + ["--device", "cpu", "MonteCarlo", "--n-samples",
                           str(CONFIGS[name]["n_samples"])])
    agent, carry, s = run_mpc.setup(args)
    s = dataclasses.replace(s, target=torch.tensor(target), physics=(
        dataclasses.replace(s.physics, qpos=torch.tensor(qpos),
                            qvel=torch.tensor(qvel))))
    carry = dataclasses.replace(carry,
                                generator=torch.Generator().manual_seed(seed))
    carry, _ = agent.warm_start(carry, s, 50)
    _, final, track = agent.run_episode(carry, s)
    return _outcome(name, agent.env, final, track["reward"].sum())


def main(argv):
    logging.disable(logging.INFO)
    if argv[0] == "reacher-sweep":
        for key in range(10):
            s, out = jax_episode(
                "reacher", lambda env, k=key: env.reset(jax.random.key(k)),
                key)
            print(json.dumps({"package": "jax", "key": key, "target_norm":
                              round(float(jnp.linalg.norm(s.target)), 3),
                              **out}), flush=True)
        return
    name = argv[0]
    qpos, qvel, target = (json.loads(a) for a in argv[1:4])
    seeds = int(argv[4]) if len(argv) > 4 else 3

    def pinned(env):
        s = env.reset(jax.random.key(0))
        return s.replace(physics=s.physics.replace(
            qpos=jnp.asarray(qpos, jnp.float32),
            qvel=jnp.asarray(qvel, jnp.float32)),
            target=jnp.asarray(target, jnp.float32))

    for seed in range(seeds):
        _, out = jax_episode(name, pinned, seed)
        print(json.dumps({"package": "jax", "seed": seed, **out}),
              flush=True)
        out = port_episode(name, qpos, qvel, target, seed)
        print(json.dumps({"package": "port", "seed": seed, **out}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
