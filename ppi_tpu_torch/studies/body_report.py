"""The rollout kernel's generated bodies, measured on the CPU.

    python -m ppi_tpu_torch.studies.body_report [ENV ...]

For each env of ``run_mpc`` (or each one named): the body's generated
lines and emitted f32 operations per lane step (``ops_per_lane_step``),
the host-C build time of the skeleton plus the body (where ``cc`` exists;
a fresh build directory under ``build/kernels/``), and how far the env's
dynamics carry a rounding difference: the plain rollout from q0 (1 + 1e-7
z) and qd0 + 1e-7 against the unperturbed one, as max |a-b| / (1+|b|) at
N=257/H=5 and N=1000/H=20 (the chip checks' shapes), with the chip
checks' action scales (0.3 for an env not listed in ``SCALE``). A body of
more than ``LONG_OPS`` operations per lane step (the 20-25-DoF Adroit
scenes) is perturbed at H=2 and H=3 instead: its plain rollout runs one
eager op per scalar op, and at H=20 would take minutes.
"""

import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import ppi_tpu_torch.build as build
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.runners.run_mpc import ENVS

SCALE = {"door-v0": 0.4, "pen-v0": 0.12, "relocate-v0": 0.3,
         "cheetah": 25.0, "door-v0-hand": 0.3, "door-v0-adroit": 0.3,
         "hammer-v0": 0.4, "pen-v0-hand": 0.5, "relocate-v0-hand": 0.3,
         "hammer-v0-hand": 0.3, "pen-v0-adroit": 0.5}
LONG_OPS = 150_000


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def main(names):
    torch.manual_seed(0)
    rng = np.random.default_rng(2)
    build.BUILD_ROOT = Path(tempfile.mkdtemp(prefix="body_report_"))
    try:
        for name in names or ENVS:
            env = ENVS[name]()
            state = env.reset(torch.Generator().manual_seed(1), "cpu")
            args = rk.body_args(env, state)
            header = rk.generate_env_header(*args)
            ops = rk.ops_per_lane_step(*args)
            line = (f"{name}: {len(header.splitlines())} lines, "
                    f"{ops} ops per lane step")
            if shutil.which("cc"):
                t0 = time.perf_counter()
                rk.load_host_rollout(header)
                line += f", host-C build {time.perf_counter() - t0:.2f} s"
            print(line, flush=True)
            shapes = ((257, 2), (1000, 3)) if ops > LONG_OPS else \
                ((257, 5), (1000, 20))
            for n, h in shapes:
                z = rng.standard_normal((n, h, env.action_dim))
                acts = torch.from_numpy(
                    (SCALE.get(name, 0.3) * z).astype(np.float32))
                q0 = state.physics.qpos.expand(n, -1)
                qd0 = state.physics.qvel.expand(n, -1)
                run = lambda q, qd: rk.env_plain_rollout(env, state, q, qd,
                                                         acts)
                base = run(q0, qd0)
                moved = run(q0 * (1.0 + 1e-7 * torch.randn(q0.shape)),
                            qd0 + 1e-7)
                diff = [rel_err(a, b) for a, b in zip(moved, base)]
                print(f"  1e-7 perturbation at N={n}/H={h}: rewards "
                      f"{diff[0]:.3g}, qf {diff[1]:.3g}, qdf {diff[2]:.3g}",
                      flush=True)
    finally:
        shutil.rmtree(build.BUILD_ROOT, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
