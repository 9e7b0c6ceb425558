"""Smoke run of the torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one line each (phase 6 one per case); any failure exits non-zero:
  1. build   -- generate the door-v0 body and build both kernels with nvcc
                for sm_90a, in parallel; print the rollout kernel's build
                time and -Xptxas -v summary;
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
                launches, the door open;
  5. build   -- the moment-match kernel's build time and -Xptxas -v summary;
  6. check   -- the moment-match kernel against its plain version and both
                against a float64 oracle on the card: (4096, 64) with
                heavy-tailed weights and 0-3 quarters masked, (4000, 640),
                (1000, 17), (256, 9) with a mean offset of 100, and every
                lane but one at -inf (ESS 1); two launches bit-identical;
  7. timings -- the kernel, the single-pass plain version and the two-pass
                m_projection (CUDA events) at (100, 20), (4096, 64),
                (4096, 640) and (16384, 640); ms per optimization iteration
                at d=640, N=4096 (sample, NoisySphere, Reps, Gaussian update);
  8. runs    -- three black-box runs through the port's run_opt (Reps,
                NoisySphere, 50 iterations, seed 0): d=640 and d=64 at
                N=4096 (exactly 50 kernel launches each), and the canonical
                d=20, N=100 (below the dispatch threshold: 0 launches).
Then one JSON line with the kernels' numbers and, last, the device line.
All numbers go to chiprun_out/chip_smoke.json as well.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

N_CHECK, H_CHECK = 1000, 20
TOL = 1e-4  # max of |kernel - plain| / (1 + |plain|), elementwise
# moment match: the kernel against its plain version (f32 sums in another
# order: mu and sigma absolute, ESS relative) ...
MM_TOL = 1e-5
# ... and both against the float64 oracle (tests/test_fuzz_solvers.py)
ORACLE_MU_ATOL, ORACLE_SIGMA_RTOL, ORACLE_SIGMA_ATOL, ORACLE_ESS_RTOL = (
    5e-4, 2e-2, 5e-2, 1e-3)
# phase 8 bounds, set from the port's CPU runs with seeds 0-4 (PERF.md)
RUNS = (  # (dimension, n_samples, launches, bound on the final cost)
    (640, 4096, 50, "ratio"), (64, 4096, 50, 400.0), (20, 100, 0, 100.0))
FINAL_RATIO = 0.5  # d=640: final cost <= this x the first iteration's


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


def build_timed(source, headers=None):
    from ppi_tpu_torch.build import build_library
    t0 = time.perf_counter()
    lib = build_library(source, headers)
    return lib, time.perf_counter() - t0


def ptxas_summary(lib):
    return [ln.strip() for ln in (lib.parent / "build.log").read_text()
            .splitlines() if "registers" in ln or "spill" in ln]


def oracle_moments(log_w, x):
    """float64 moment match on the card (tests/test_fuzz_solvers.py)."""
    lw, x = log_w.double(), x.double()
    w = torch.exp(lw - lw.max())
    w = w / w.sum()
    mu = w @ x
    dev = x - mu
    return mu, (w[:, None] * dev).T @ dev, 1.0 / (w * w).sum()


def main():
    with ThreadPoolExecutor(max_workers=2) as pool:
        return run(pool)


def run(pool):
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
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.base import batch_rollout, mpc_objective
    from ppi_tpu_torch.envs.door import DOOR, Door
    from ppi_tpu_torch.envs.functions import make_function
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    from ppi_tpu_torch.ops import m_projection
    from ppi_tpu_torch.ops.cuda_ops import (
        m_projection_cuda, m_projection_plain)
    from ppi_tpu_torch.policies import design_moments, make_policy
    from ppi_tpu_torch.policies.gaussian import Gaussian
    from ppi_tpu_torch.runners import run_mpc, run_opt

    # ---- 1. build (both kernels, in parallel) ------------------------------
    door = Door(fixed_scene=True)
    t0 = time.perf_counter()
    header = rk.generate_env_header(
        door._model, door.dt, door.substeps, door.action_dim,
        door.scalar_torque, door.scalar_reward, door.scalar_dyn_body)
    rollout_build = pool.submit(build_timed, "rollout.cu",
                                {"env_body.h": header})
    mm_build = pool.submit(build_timed, "moment_match.cu")
    lib, _ = rollout_build.result()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(lib)
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
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ret, success, track = run_mpc.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES["rollout"]
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

    # ---- 5. build the moment-match kernel ---------------------------------------
    mm_lib, mm_build_s = mm_build.result()
    mm_ptxas = ptxas_summary(mm_lib)
    print(f"mm build: {mm_build_s:.1f} s (in parallel with phase 1); "
          f"ptxas: {' | '.join(mm_ptxas)}", flush=True)
    out.update(mm_build_s=mm_build_s, mm_ptxas=mm_ptxas)

    # ---- 6. moment match: kernel vs plain vs float64 oracle ----------------------
    def mm_inputs(n, d, seed, masked_q=0, offset=0.0, one_lane=False):
        g = torch.Generator(dev).manual_seed(seed)
        x = offset + torch.randn(n, d, generator=g, device=dev)
        # heavy-tailed log-weights: scale 3, weights over e^+-9
        lw = 3.0 * torch.randn(n, generator=g, device=dev)
        lw[torch.randperm(n, generator=g, device=dev)[:n * masked_q // 4]] \
            = -torch.inf
        if one_lane:
            lw = torch.full((n,), -torch.inf, device=dev)
            lw[n // 3] = 0.0
        return lw, x

    cases = [(f"4096x64_masked{q}q", (4096, 64, 10 + q, q)) for q in range(4)]
    cases += [("4000x640", (4000, 640, 20)), ("1000x17", (1000, 17, 21)),
              ("256x9_offset100", (256, 9, 22, 0, 100.0)),
              ("512x64_one_lane", (512, 64, 23, 0, 0.0, True))]
    mm_errs, mm_max_abs = {}, 0.0
    for case, args_ in cases:
        lw, x = mm_inputs(*args_)
        k = m_projection_cuda(lw, x)
        p = m_projection_plain(lw, x)
        o = oracle_moments(lw, x)
        torch.cuda.synchronize()
        kp = [float((a - b).abs().max()) for a, b in zip(k[:2], p[:2])]
        ess_rel = abs(float(k[2]) - float(p[2])) / float(p[2])
        mm_max_abs = max(mm_max_abs, *kp, abs(float(k[2]) - float(p[2])))
        check(max(kp) <= MM_TOL and ess_rel <= MM_TOL,
              f"moment match {case}: kernel vs plain {kp}, ESS {ess_rel}")
        for label, (mu, sigma, ess) in (("kernel", k), ("plain", p)):
            mu_err = float((mu.double() - o[0]).abs().max())
            sig_ok = bool(((sigma.double() - o[1]).abs()
                           <= ORACLE_SIGMA_ATOL
                           + ORACLE_SIGMA_RTOL * o[1].abs()).all())
            ess_err = abs(float(ess) - float(o[2])) / float(o[2])
            check(mu_err <= ORACLE_MU_ATOL and sig_ok
                  and ess_err <= ORACLE_ESS_RTOL,
                  f"moment match {case}: {label} vs oracle mu {mu_err}, "
                  f"sigma ok {sig_ok}, ESS {ess_err}")
            if case.endswith("offset100"):
                diag = torch.diagonal(sigma).double()
                check(bool(((diag - torch.diagonal(o[1])).abs()
                            <= 0.05 * torch.diagonal(o[1]).abs()).all()),
                      f"moment match {case}: {label} lost the covariance")
        if case.endswith("one_lane"):
            check(float(k[2]) == 1.0, f"one live lane: ESS {float(k[2])}")
        mm_errs[case] = {"kernel_vs_plain": kp, "ess_rel": ess_rel}
        print(f"mm check {case}: kernel vs plain mu/sigma {kp[0]:.3g}/"
              f"{kp[1]:.3g}, ESS rel {ess_rel:.3g}", flush=True)
    lw, x = mm_inputs(4000, 640, 20)
    first = m_projection_cuda(lw, x)
    again = m_projection_cuda(lw, x)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "two launches on one input differ")
    print(f"mm check: all within {MM_TOL} of plain and the oracle bounds; "
          f"max abs err {mm_max_abs:.3g}; repeat launches bit-identical",
          flush=True)
    out.update(mm_check=mm_errs, mm_max_abs_err=mm_max_abs)

    # ---- 7. moment-match timings -------------------------------------------------
    mm_times = {}
    for n, d in ((100, 20), (4096, 64), (4096, 640), (16384, 640)):
        lw, x = mm_inputs(n, d, 30)
        for label, fn in (
                ("kernel", m_projection_cuda),
                ("plain", m_projection_plain),
                ("two_pass", lambda l, s: m_projection(l, s, "never"))):
            mm_times[f"{label}_ms_{n}x{d}"] = cuda_ms(lambda: fn(lw, x), 50)
    d, n = 640, 4096
    fam = Gaussian(dim=d)
    state = fam.init(torch.ones(d, device=dev),
                     0.5 * torch.eye(d, device=dev))
    step = _one_iteration(make_solver("Reps"), fam,
                          make_function("NoisySphere", d), n)
    gen = torch.Generator(dev).manual_seed(0)
    for _ in range(3):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        state, (stats, _, _) = step(state, gen)
    torch.cuda.synchronize()
    mm_times["opt_iter_ms_d640_N4096"] = 1e3 * (time.perf_counter() - t0) / 20
    check(bool(torch.isfinite(stats["mean"])), "opt iteration not finite")
    print(f"mm timings: {json.dumps(mm_times)}", flush=True)
    out.update(mm_timings=mm_times)

    # ---- 8. black-box runs through run_opt ---------------------------------------
    runs, mm_launches = {}, 0
    for dim, n_samples, expected, bound in RUNS:
        args = run_opt.build_parser().parse_args([
            "Reps", "NoisySphere", "--dimension", str(dim), "--n-iter", "50",
            "--seed", "0", "--device", "cuda", "mc", "--n-samples",
            str(n_samples)])
        LAUNCHES.clear()
        t0 = time.perf_counter()
        state, trace = run_opt.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = LAUNCHES["moment_match"]
        mm_launches += got
        first, final = float(trace["mean"][0]), float(trace["mean"][-1])
        limit = FINAL_RATIO * first if bound == "ratio" else bound
        check(got == expected, f"run d={dim}: {got} kernel launches, "
              f"expected {expected}")
        check(np.isfinite(trace["mean"]).all()
              and bool(torch.isfinite(state.mu).all()),
              f"run d={dim}: non-finite trace or mean")
        check(final <= limit, f"run d={dim}: final cost {final} above "
              f"{limit} (first {first})")
        runs[f"d{dim}_N{n_samples}"] = {"first": first, "final": final,
                                        "launches": got, "wall_s": wall}
        print(f"run d={dim} N={n_samples}: cost {first:.6g} -> {final:.6g} "
              f"(limit {limit:.6g}), {got} kernel launches, wall "
              f"{wall:.2f} s", flush=True)
    out.update(runs=runs)

    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/chip_smoke.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({"kernels": [
        {"name": "door_rollout", "route": "cuda",
         "source": "ppi_tpu_torch/csrc/rollout.cu",
         "replaces": "ppi_tpu/envs/physics/pallas_rollout.py:190",
         "launches": launches, "max_abs_err": max_abs,
         "ms": timings["kernel_ms_N1024_H160"],
         "plain_ms": timings["plain_ms_N1024_H160"]},
        {"name": "moment_match", "route": "cuda",
         "source": "ppi_tpu_torch/csrc/moment_match.cu",
         "replaces": "ppi_tpu/ops/pallas_ops.py:78",
         "launches": mm_launches, "max_abs_err": mm_max_abs,
         "ms": mm_times["kernel_ms_4096x640"],
         "plain_ms": mm_times["plain_ms_4096x640"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
