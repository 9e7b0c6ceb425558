"""What FMA contraction does to the rollout kernel, on one CUDA card.

    python -m ppi_tpu_torch.studies.fma_contraction

Builds each env's body of ``csrc/rollout.cu`` twice, with nvcc's default
contraction and with ``-fmad=false`` (the build the port uses), then for
door-v0, pen-v0, relocate-v0 and cheetah prints:

  * each build's ``-Xptxas -v`` summary;
  * the largest difference between the two builds' rewards and final state
    at N=1000, H=20 (max |a-b| / (1+|b|));
  * both builds' kernel times (CUDA events, 20 launches, in the turns
    contracted, exact, exact, contracted) at the shapes the main paths use.

The numbers also go to ``chiprun_out/fma_contraction.json``.
"""

import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import ppi_tpu_torch.build as build
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.runners.run_mpc import ENVS

SHAPES = {"door-v0": [(1024, 160), (64, 30)],
          "pen-v0": [(96, 15), (1024, 160)],
          "relocate-v0": [(256, 20)], "cheetah": [(256, 30)]}
SCALE = {"door-v0": 0.4, "pen-v0": 0.12, "relocate-v0": 0.3,
         "cheetah": 25.0}
EXACT = dict(build.SOURCE_NVCC_FLAGS)
BUILDS = {"contracted": {}, "exact": EXACT}


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rollouts(env, state, horizon):
    """{build: run(q0, qd0, actions)}, each built and loaded."""
    consts, _, dyn = rk.kernel_operands(env, state)
    out, ptxas = {}, {}
    for label, flags in BUILDS.items():
        build.SOURCE_NVCC_FLAGS = flags
        run = rk.env_rollout(env, state, horizon)
        out[label] = (lambda run: lambda q, qd, a: run(
            q, qd, a, consts=consts, dyn=dyn))(run)
        q = state.physics.qpos.expand(1, -1).contiguous()
        out[label](q, torch.zeros_like(q), torch.zeros(
            (1, horizon, env.action_dim), device=q.device))  # build, load
        lib = rk._library(rk.generate_env_header(*rk.body_args(env, state)))
        ptxas[label] = [ln.strip() for ln in (lib.parent / "build.log")
                        .read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
    build.SOURCE_NVCC_FLAGS = EXACT
    return out, ptxas


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fma_contraction: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    result = {"card": card}
    for name, shapes in SHAPES.items():
        env = ENVS[name]()
        state = env.reset(torch.Generator(dev).manual_seed(1), dev)
        res = {}
        for n, h in [(1000, 20)] + shapes:
            runs, ptxas = rollouts(env, state, h)
            res["ptxas"] = ptxas
            acts = torch.from_numpy((SCALE[name] * rng.standard_normal(
                (n, h, env.action_dim))).astype(np.float32)).to(dev)
            q = state.physics.qpos.expand(n, -1).contiguous()
            qd = state.physics.qvel.expand(n, -1).contiguous()
            if (n, h) == (1000, 20):
                diff = {k: rel_err(a, b) for k, a, b in zip(
                    ("rewards", "qf", "qdf"), runs["contracted"](q, qd, acts),
                    runs["exact"](q, qd, acts))}
                res["difference_N1000_H20"] = diff
                print(f"{name}: contracted vs exact at N=1000/H=20: "
                      f"{json.dumps(diff)}", flush=True)
                continue
            times = {"contracted": [], "exact": []}
            for label in ("contracted", "exact", "exact", "contracted"):
                times[label].append(cuda_ms(
                    lambda: runs[label](q, qd, acts)))
            res[f"ms_N{n}_H{h}"] = times
            print(f"{name} N={n} H={h}: ms {json.dumps(times)}", flush=True)
        for label, lines in res["ptxas"].items():
            print(f"{name} {label}: {' | '.join(lines)}", flush=True)
        result[name] = res
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/fma_contraction.json").write_text(
        json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
