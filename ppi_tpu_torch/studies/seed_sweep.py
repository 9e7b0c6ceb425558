"""One MPC configuration through the port's runner over a range of seeds.

    python -m ppi_tpu_torch.studies.seed_sweep --seeds 0-9 Lbps \\
        hammer-v0-hand SquaredExponentialKernel --delta 0.9 --n-iters 2 \\
        --anneal 0.5 --lengthscale 0.08 --timesteps 400 --horizon 30 \\
        MonteCarlo --n-samples 128

Takes ``run_mpc``'s arguments after ``--seeds FIRST-LAST``; the seed sets
the agent's draws and the sampled scene (board, goal or frame). Prints,
per seed, the return, the success flag, the episode's wall time, the
sampled target or goal (for an env with one) and the final and the
per-coordinate largest ``qpos`` (for hammer-v0-hand:
coordinates 6-8 are the free hammer's x, z and pitch, 9 the nail's depth;
a hammer that was lifted shows in the largest z, one that was knocked away
in the final x), then the success count. The rows also go to
``chiprun_out/seed_sweep.json``. One process: the kernels build once.
"""

import json
import sys
import time
from pathlib import Path

import torch

from ppi_tpu_torch.runners import run_mpc


def main(argv):
    if len(argv) < 2 or argv[0] != "--seeds":
        raise SystemExit(__doc__)
    first, last = (int(x) for x in argv[1].split("-"))
    rows = []
    for seed in range(first, last + 1):
        args = run_mpc.build_parser().parse_args(
            ["--seed", str(seed)] + argv[2:])
        peak, final, target = [], [], []

        def track(t, state, row):
            q = state.physics.qpos
            peak[:] = [q if not peak else torch.maximum(peak[0], q)]
            final[:] = [q]
            target[:] = [getattr(state, "target", None)]
            return False

        t0 = time.perf_counter()
        ret, success, _ = run_mpc.main(args, callback=track)
        rows.append({"seed": seed, "return": ret, "success": success,
                     "wall_s": time.perf_counter() - t0,
                     "final_qpos": [round(float(x), 4) for x in final[0]],
                     "max_qpos": [round(float(x), 4) for x in peak[0]]})
        if target[0] is not None:
            rows[-1]["target"] = [round(float(x), 4) for x in target[0]]
        print(f"{args.env} {json.dumps(rows[-1])}", flush=True)
    done = sum(bool(r["success"]) for r in rows)
    print(f"{args.env}: success at {done} of {len(rows)} seeds "
          f"({first}-{last})", flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/seed_sweep.json").write_text(json.dumps(
        {"argv": argv, "rows": rows}))


if __name__ == "__main__":
    main(sys.argv[1:])
