"""What replanning does to a warm-started plan, step by step.

    python -m ppi_tpu_torch.studies.replan_trace --steps 40 --show 6,7,8,9 \\
        Lbps hammer-v0-hand SquaredExponentialKernel --delta 0.9 \\
        --n-iters 2 --anneal 0.5 --lengthscale 0.08 --timesteps 400 \\
        --horizon 30 MonteCarlo --n-samples 128

Takes ``run_mpc``'s arguments after ``--steps N`` (control steps to trace)
and ``--show i,j,...`` (the ``qpos`` coordinates to print; for
hammer-v0-hand 6-9 are the hammer's x, z, pitch and the nail's depth).
After the warm start it runs the same state twice:

  * open loop: the warm-started mean plan, executed action by action with
    no replanning (its first H steps), with each step's reward;
  * closed loop: the MPC episode's first N control steps, with each step's
    reward and the planner's statistics over its last batch of sampled
    plans (mean and spread of their costs, ESS, temperature).

A plan that succeeds open loop and is lost closed loop shows what the
window shift (``--anneal``) and the posterior update do to it. The rows
also go to ``chiprun_out/replan_trace.json``.
"""

import json
import sys
from pathlib import Path

from ppi_tpu_torch.runners import run_mpc


def _option(argv, name, default):
    if name not in argv:
        return default, argv
    i = argv.index(name)
    return argv[i + 1], argv[:i] + argv[i + 2:]


def main(argv):
    steps, argv = _option(argv, "--steps", "40")
    show, argv = _option(argv, "--show", "0,1,2")
    show = [int(i) for i in show.split(",")]
    args = run_mpc.build_parser().parse_args(argv)
    agent, carry, state0 = run_mpc.setup(args)
    env = agent.env
    carry, wtrace = agent.warm_start(carry, state0, args.n_warmstart_iters)
    print(f"warm start: plan costs {float(wtrace['mean'][-1]):.6g} +/- "
          f"{float(wtrace['std'][-1]):.6g}", flush=True)
    coords = lambda s: [round(float(s.physics.qpos[i]), 4) for i in show]

    out = {"argv": argv, "open_loop": [], "closed_loop": []}
    plan, state = agent.family.predict_mean(carry.policy), state0
    for t in range(min(agent.horizon, int(steps))):
        state, reward = env.step(state, plan[t])
        out["open_loop"].append({"t": t, "reward": float(reward),
                                 "qpos": coords(state)})
        print(f"open loop   t {t:3d} reward {float(reward):9.4g} qpos{show} "
              f"{coords(state)}", flush=True)
    if hasattr(env, "success"):
        out["open_loop_success"] = bool(env.success(state))
        print(f"open loop: success {out['open_loop_success']}", flush=True)

    state = state0
    for t in range(int(steps)):
        action, carry, stats = agent.control_step(carry, state, t)
        state, reward = env.step(state, action)
        row = {"t": t, "reward": float(reward), "qpos": coords(state),
               **{k: float(stats[k]) for k in ("mean", "std", "ess",
                                               "alpha")}}
        out["closed_loop"].append(row)
        print(f"closed loop t {t:3d} reward {row['reward']:9.4g} qpos{show} "
              f"{row['qpos']} plan costs {row['mean']:.5g} +/- "
              f"{row['std']:.4g} ess {row['ess']:.4g} alpha "
              f"{row['alpha']:.4g}", flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/replan_trace.json").write_text(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
