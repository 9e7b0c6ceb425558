"""Smoke run of the torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. build   -- generate the door-v0 body and build the rollout kernel with
                nvcc for sm_90a; print the build time and -Xptxas -v summary;
  2. check   -- the kernel against its plain version (the eager rollout) on
                the card at N=1000 (ragged), H=20: final state and rewards,
                a pre-poisoned NaN lane, the horizon mask in the objective,
                and a sampled door frame;
  3. timings -- kernel time (CUDA events) at N=1024/H=160 and N=64/H=30,
                the plain rollout at N=1024/H=160, ms per PPI iteration at
                N=1024/H=160 (sample -> kernel -> LBPS update);
  4. episode -- the canonical door-v0 episode through the port's runner
                (Lbps, SE kernel, delta 0.9, 2 iters, anneal 0.5,
                lengthscale 0.08, 64 samples, H=30, T=250, 50 warm-start
                iterations, seed 0): finite return, exactly 550 kernel
                launches, the door open.
Then one JSON line with the kernel's numbers and, last, the device line.
All numbers go to chiprun_out/chip_smoke.json as well.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_CHECK, H_CHECK = 1000, 20
TOL = 1e-4  # max of |kernel - plain| / (1 + |plain|), elementwise


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    # f32 everywhere: TF32 matmuls and convolutions off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out = {"card": smi, "device": name}

    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.envs.base import batch_rollout, mpc_objective
    from ppi_tpu_torch.envs.door import DOOR, Door
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.policies import design_moments, make_policy
    from ppi_tpu_torch.runners import run_mpc

    # ---- 1. build ----------------------------------------------------------
    door = Door(fixed_scene=True)
    t0 = time.perf_counter()
    header = rk.generate_env_header(
        door._model, door.dt, door.substeps, door.action_dim,
        door.scalar_torque, door.scalar_reward, door.scalar_dyn_body)
    lib = rk.build_library(header)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: {build_s:.1f} s, {len(header.splitlines())} generated "
          f"lines; ptxas: {' | '.join(ptxas)}", flush=True)
    out.update(build_s=build_s, ptxas=ptxas)

    def make_run(horizon, d=door):
        return rk.make_rollout(d._model, d.dt, d.substeps, horizon,
                               d.action_dim, d.scalar_torque,
                               d.scalar_reward, dyn_body=DOOR)

    def lanes(state, n):
        return (state.physics.qpos.expand(n, -1).contiguous(),
                state.physics.qvel.expand(n, -1).contiguous())

    # ---- 2. kernel vs plain ----------------------------------------------------
    rng = np.random.default_rng(0)
    acts = torch.from_numpy((0.4 * rng.standard_normal(
        (N_CHECK, H_CHECK, door.action_dim))).astype(np.float32)).to(dev)
    s0 = door.reset(None, dev)
    q0, qd0 = lanes(s0, N_CHECK)
    run = make_run(H_CHECK)
    rew, qf, qdf = run(q0, qd0, acts, dyn=s0.frame)
    fin, rew_p = batch_rollout(door, s0, acts)
    torch.cuda.synchronize()
    check(rew.shape == (N_CHECK, H_CHECK) and qf.shape == (N_CHECK, 6),
          f"output shapes {tuple(rew.shape)}, {tuple(qf.shape)}")
    errs = {"rewards": rel_err(rew, rew_p),
            "qf": rel_err(qf, fin.physics.qpos),
            "qdf": rel_err(qdf, fin.physics.qvel)}
    max_abs = max(float((rew - rew_p).abs().max()),
                  float((qf - fin.physics.qpos).abs().max()),
                  float((qdf - fin.physics.qvel).abs().max()))
    check(max(errs.values()) <= TOL, f"kernel vs plain {errs} > {TOL}")

    q0_bad = q0.clone()
    q0_bad[3] = torch.nan
    rew_bad, _, _ = run(q0_bad, qd0, acts, dyn=s0.frame)
    others = torch.cat([rew_bad[:3], rew_bad[4:]])
    check(bool(torch.isnan(rew_bad[3]).all())
          and bool(torch.isfinite(others).all())
          and bool(torch.equal(others, torch.cat([rew[:3], rew[4:]]))),
          "a NaN lane must go NaN alone")

    mask = (torch.arange(H_CHECK, device=dev) < H_CHECK - 5).float()
    c_k = rk.kernel_mpc_objective(door, s0, H_CHECK, mask)(None, acts)
    c_p = mpc_objective(door, s0, mask)(None, acts)
    c_full = rk.kernel_mpc_objective(door, s0, H_CHECK)(None, acts)
    errs["masked_costs"] = rel_err(c_k, c_p)
    check(errs["masked_costs"] <= TOL
          and bool(torch.allclose(c_k, -(rew * mask).sum(1)))
          and not bool(torch.allclose(c_k, c_full)),
          f"horizon mask: {errs['masked_costs']}")

    sampled = Door()
    s1 = sampled.reset(torch.Generator(dev).manual_seed(1), dev)
    check(not bool(torch.equal(s1.frame, s0.frame)), "frame not sampled")
    c_k1 = rk.kernel_mpc_objective(sampled, s1, H_CHECK)(None, acts)
    c_p1 = mpc_objective(sampled, s1)(None, acts)
    errs["sampled_frame_costs"] = rel_err(c_k1, c_p1)
    check(errs["sampled_frame_costs"] <= TOL
          and not bool(torch.allclose(c_k1, c_full)),
          f"sampled frame: {errs['sampled_frame_costs']}")
    print(f"check: N={N_CHECK} H={H_CHECK} errors {json.dumps(errs)} "
          f"(tol {TOL}); max abs err {max_abs:.3g}; NaN lane isolated; "
          f"mask and sampled frame applied", flush=True)
    out.update(check_errors=errs, max_abs_err=max_abs)

    # ---- 3. timings ------------------------------------------------------------
    timings = {}
    for n, h, iters in ((1024, 160, 20), (64, 30, 200)):
        a = torch.from_numpy((0.4 * rng.standard_normal(
            (n, h, door.action_dim))).astype(np.float32)).to(dev)
        qn, qdn = lanes(s0, n)
        r = make_run(h)
        timings[f"kernel_ms_N{n}_H{h}"] = cuda_ms(
            lambda: r(qn, qdn, a, dyn=s0.frame), iters)
    a = torch.from_numpy((0.4 * rng.standard_normal(
        (1024, 160, door.action_dim))).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_rollout(door, s0, a)
    torch.cuda.synchronize()
    timings["plain_ms_N1024_H160"] = 1e3 * (time.perf_counter() - t0)

    mean, cov_in, cov_out = design_moments(door.action_low, door.action_high,
                                           ratio=1000.0)
    family, policy = make_policy(
        "SquaredExponentialKernel", door.dt * torch.arange(160),
        door.action_dim, mean, cov_in, cov_out, lengthscale=4 * door.dt,
        lower=door.action_low, upper=door.action_high, device=dev)
    step = _one_iteration(make_solver("Lbps", delta=0.9), family,
                          rk.kernel_mpc_objective(door, s0, 160), 1024)
    gen = torch.Generator(dev).manual_seed(0)
    state = policy
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    timings["ppi_iter_ms_N1024_H160"] = (1e3 * (time.perf_counter() - t0)
                                         / iters)
    check(bool(torch.isfinite(stats["mean"])), "PPI iteration cost not finite")
    print(f"timings: {json.dumps(timings)}", flush=True)
    out.update(timings=timings)

    # ---- 4. the canonical episode ----------------------------------------------
    args = run_mpc.build_parser().parse_args([
        "Lbps", "door-v0", "SquaredExponentialKernel", "--delta", "0.9",
        "--n-iters", "2", "--anneal", "0.5", "--lengthscale", "0.08",
        "--horizon", "30", "--timesteps", "250", "--n-warmstart-iters", "50",
        "--seed", "0", "--device", "cuda", "MonteCarlo", "--n-samples", "64"])
    rk.LAUNCHES.clear()
    t0 = time.perf_counter()
    ret, success, track = run_mpc.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rk.LAUNCHES["rollout"]
    expected = 50 + 250 * 2
    check(np.isfinite(ret), f"episode return {ret}")
    check(track["action"].shape == (250, door.action_dim)
          and bool(torch.isfinite(track["action"]).all()),
          "episode actions not finite")
    check(launches == expected, f"{launches} kernel launches, expected "
          f"{expected}")
    check(success, f"door not open (return {ret:.2f})")
    print(f"episode: return {ret:.2f}, success {success}, {launches} kernel "
          f"launches, wall {wall:.1f} s", flush=True)
    out.update(episode_return=ret, episode_success=success,
               episode_wall_s=wall, episode_launches=launches)

    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/chip_smoke.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"kernels": [{
        "name": "door_rollout", "route": "cuda",
        "source": "ppi_tpu_torch/csrc/rollout.cu",
        "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
        "launches": launches, "max_abs_err": max_abs,
        "ms": timings["kernel_ms_N1024_H160"],
        "plain_ms": timings["plain_ms_N1024_H160"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
