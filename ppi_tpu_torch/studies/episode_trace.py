"""One MPC episode through the port's runner, traced step by step.

    python -m ppi_tpu_torch.studies.episode_trace Mppi cheetah \\
        ColouredNoise --beta 2 --timesteps 150 MonteCarlo --n-samples 256

Takes ``run_mpc``'s arguments. Prints, every ``--every`` steps and at every
step whose reward leaves [-100, 100], the step's reward, the largest
|qvel| and the first three coordinates of qpos (cheetah: x, torso height,
pitch), then the return. The rows also go to
``chiprun_out/episode_trace.json``.
"""

import json
import sys
from pathlib import Path

from ppi_tpu_torch.runners import run_mpc


def main(argv):
    every = 10
    if "--every" in argv:
        i = argv.index("--every")
        every = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    args = run_mpc.build_parser().parse_args(argv)
    rows = []

    def trace(t, state, row):
        q, qd = state.physics.qpos, state.physics.qvel
        rows.append({"t": t, "reward": float(row["reward"]),
                     "max_abs_qvel": float(qd.abs().max()),
                     "qpos_0_3": [float(x) for x in q[:3]]})
        r = rows[-1]
        if t % every == 0 or abs(r["reward"]) > 100.0:
            print(f"t {t:4d} reward {r['reward']:.6g} max|qvel| "
                  f"{r['max_abs_qvel']:.6g} qpos[:3] "
                  f"{' '.join(f'{x:.4g}' for x in r['qpos_0_3'])}",
                  flush=True)
        return False

    ret, success, _ = run_mpc.main(args, callback=trace)
    print(f"{args.env} seed {args.seed}: return {ret:.6g}, success "
          f"{success}", flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/episode_trace.json").write_text(json.dumps(
        {"argv": argv, "return": ret, "rows": rows}))


if __name__ == "__main__":
    main(sys.argv[1:])
