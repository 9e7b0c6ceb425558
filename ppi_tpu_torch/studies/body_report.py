"""The rollout kernel's generated bodies, measured on the CPU.

    python -m ppi_tpu_torch.studies.body_report [ENV ...]
    python -m ppi_tpu_torch.studies.body_report --stages [ENV ...]

With ``--stages``: the f32 operations (``Emitter.ops``) of a lane step
(``ops_per_lane_step``, the bound's count) and of one generated substep
by stage of ``engine_soa`` (``STAGES``, then the mass-matrix entries and
the right-hand side's sums, the solve and the integration); for a body of
the warp layout also the operations of its lane-0 function
``env_assemble``.

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

import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import ppi_tpu_torch.build as build
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.runners.run_mpc import ENVS, KERNEL_ENVS

SCALE = {"door-v0": 0.4, "pen-v0": 0.12, "relocate-v0": 0.3,
         "cheetah": 25.0, "door-v0-hand": 0.3, "door-v0-adroit": 0.3,
         "hammer-v0": 0.4, "pen-v0-hand": 0.5, "relocate-v0-hand": 0.3,
         "hammer-v0-hand": 0.3, "pen-v0-adroit": 0.5}
LONG_OPS = 150_000


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


# engine_soa functions whose emitted ops ``stage_ops`` counts, outermost
# call only (a helper's ops count towards the stage that called it)
STAGES = {"fk_soa": "FK", "_jacobians": "Jacobians",
          "world_inertia_soa": "world inertias", "m3_vec": "I_w jw",
          "velocity_kinematics_soa": "velocity kinematics",
          "contact_points_soa": "contact points",
          "contact_forces_soa": "contacts", "passive_torque_soa": "passive",
          "bias_wrench_soa": "bias wrenches"}


def stage_ops(name):
    """{stage: emitted f32 ops} of one substep of ``name``'s body, and
    (for the warp layout) of its lane-0 function ``env_assemble``."""
    import contextlib
    from ppi_tpu_torch.envs.physics import engine_soa as es
    from ppi_tpu_torch.envs.physics import scalar_math as sm
    env = ENVS[name]()
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    m = es.SoaModel(env._model)
    _, dyn_body, _ = rk.kernel_operands(env, state)
    counts = dict.fromkeys(STAGES.values(), 0)
    em = sm.Emitter()
    q = tuple(em.input(f"q_{j}", "q") for j in range(m.nq))
    qd = tuple(em.input(f"qd_{j}", "qd") for j in range(m.nq))
    tau = tuple(em.input(f"tau_{j}", "tau") for j in range(m.nq))
    mm = m if dyn_body is None else m.with_body_offset(
        dyn_body, tuple(em.input(f"dyn_{k}", "dyn") for k in range(3)))
    depth = [0]

    @contextlib.contextmanager
    def counted():
        saved = {k: getattr(es, k) for k in STAGES}

        def wrap(key, fn):
            def inner(*a, **k):
                before = em.ops
                depth[0] += 1
                try:
                    return fn(*a, **k)
                finally:
                    depth[0] -= 1
                    if depth[0] == 0:
                        counts[STAGES[key]] += em.ops - before
            return inner
        for key, fn in saved.items():
            setattr(es, key, wrap(key, fn))
        try:
            yield
        finally:
            for key, fn in saved.items():
                setattr(es, key, fn)

    with counted():
        a = es.assemble_soa(mm, q, qd, tau)
    counts["entries"] = em.ops - sum(counts[k] for k in STAGES.values())
    counts["assembly"] = em.ops
    before = em.ops
    qdd = es.solve_pd_scalar(a.mass, a.rhs)
    counts["solve"] = em.ops - before
    before = em.ops
    es.integrate_soa(mm, q, qd, qdd, a.mdiag, env.dt / env.substeps)
    counts["integrate"] = em.ops - before
    counts["substep"] = em.ops
    args = rk.body_args(env, state)
    counts["lane step"] = rk.ops_per_lane_step(*args)
    if rk.kernel_layout(env) == "warp":
        body = rk.generate_warp_header(*args).split(
            "void env_assemble(", 1)[1].split("PPI_QUAL", 1)[0]
        exprs = re.findall(r"^  const float t\d+ = (.*);$", body, re.M)
        counts["lane 0"] = sum(not sm._LITERAL.fullmatch(e) for e in exprs)
    return counts


def report_stages(names):
    for name in names or KERNEL_ENVS:
        c = stage_ops(name)
        parts = ", ".join(f"{k} {c[k]}" for k in STAGES.values())
        line = (f"{name}: {c['lane step']} ops a lane step; a substep "
                f"{c['substep']}: {parts}, mass-matrix and right-hand-side "
                f"sums {c['entries']}, solve {c['solve']} "
                f"({100.0 * c['solve'] / c['substep']:.0f}%), integrate "
                f"{c['integrate']}")
        if "lane 0" in c:
            line += (f"; warp layout: lane 0's env_assemble {c['lane 0']} "
                     f"(the rest spread over the lanes)")
        print(line, flush=True)


def main(names):
    torch.manual_seed(0)
    rng = np.random.default_rng(2)
    build.BUILD_ROOT = Path(tempfile.mkdtemp(prefix="body_report_"))
    try:
        for name in names or KERNEL_ENVS:
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
    if sys.argv[1:2] == ["--stages"]:
        report_stages(sys.argv[2:])
    else:
        main(sys.argv[1:])
