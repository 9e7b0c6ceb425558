"""The rollout kernel's two layouts side by side, on the card.

    python -m ppi_tpu_torch.studies.warp_layout [ENV ...]

For each env (the eight warp-layout bodies, door-v0-adroit,
hammer-v0-adroit, relocate-v0-adroit, door-v0-hand, hammer-v0-hand,
relocate-v0-hand, pen-v0-adroit and fetch-pick, unless named): builds the
lane layout
(``csrc/rollout.cu``) and the warp layout (``csrc/rollout_warp.cu``) of
its body in parallel and prints each build's ``-Xptxas -v`` summary;
checks at N=257 (ragged), H=3 that the two layouts give the same bits and
match the plain version; then times (CUDA events) at the env's canonical
shape and at N=1024: the lane layout at 128, 32, 8 and 1 threads a block,
the warp layout at 1, 2, 4 and 8 rollouts (warps) a block, then the two
layouts as the main path launches them (128 threads, 1 rollout a block)
in turns, lane, warp, warp, lane, at the canonical shape (``abba``), and
the real step (N=1, H=1) in both layouts;
then, from a build of the warp layout with ``PPI_STAGE_CLOCKS`` defined,
the SM cycles of each stage (lane 0's clock, so the cooperative stages
count their slowest lane and their ``__syncwarp``) per rollout and substep
(per step for the torque and the reward) at both shapes. Prints one JSON
line per env, with the card's name and power limit from ``nvidia-smi``,
and each build's SASS instruction mix (``cuobjdump -sass``: the kernel's
instructions by class). Exits non-zero without a card or on a mismatch.
"""

import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.runners.run_mpc import ENVS

# env -> (canonical N, H), the scale of the random PD targets
CANONICAL = {"door-v0-adroit": ((64, 30), 0.3),
             "hammer-v0-adroit": ((128, 30), 0.3),
             "relocate-v0-adroit": ((256, 20), 0.3),
             "door-v0-hand": ((64, 30), 0.3),
             "hammer-v0-hand": ((128, 30), 0.3),
             "relocate-v0-hand": ((256, 20), 0.3),
             "pen-v0-adroit": ((96, 15), 0.3),
             "fetch-pick": ((384, 20), 0.3)}
BLOCKS = (128, 32, 8, 1)
WARPS = (1, 2, 4, 8)
N_CHECK, H_CHECK = 257, 3


# SASS opcode classes of ``sass_mix``
SASS_CLASSES = {
    "local (spill)": ("LDL", "STL"), "shared": ("LDS", "STS"),
    "global": ("LDG", "STG", "LD", "ST"), "f32": ("FADD", "FMUL", "FFMA"),
    "special (MUFU)": ("MUFU",), "branch": ("BRA", "BSSY", "BSYNC", "CALL",
                                             "RET", "WARPSYNC", "EXIT")}


def sass_mix(lib):
    """{class: instructions} of the kernel in ``lib`` (``cuobjdump
    -sass``), with the total; None where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    ops = [m.group(1).split(".")[0] for m in (
        re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                                r"([A-Z][A-Z0-9_.]*)", ln)
        for ln in text.splitlines()) if m]
    out = {"total": len(ops)}
    for cls, names in SASS_CLASSES.items():
        out[cls] = sum(op in names for op in ops)
    return out


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
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


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def lanes(env, state, n, h, scale, seed=1):
    """The state's posture in every lane, PD targets about it."""
    q0 = state.physics.qpos.expand(n, -1).contiguous()
    qd0 = state.physics.qvel.expand(n, -1).contiguous()
    rng = np.random.default_rng(seed)
    acts = q0[:, None, :env.action_dim] + torch.from_numpy(
        (scale * rng.standard_normal((n, h, env.action_dim))).astype(
            np.float32)).to(q0.device)
    return q0, qd0, acts


def rollout(env, state, horizon, layout, size):
    """``make_rollout`` for ``env`` in ``layout`` with ``size`` threads
    (lane) or warps (warp) a block."""
    args = rk.body_args(env, state)
    model, dt, substeps, da, torque, reward, dyn_body, n_consts, \
        takes_action, project = args
    kw = {"block": size} if layout == "lane" else {"warps": size}
    return rk.make_rollout(model, dt, substeps, horizon, da, torque, reward,
                           project_fn=project, n_consts=n_consts,
                           reward_takes_action=takes_action,
                           dyn_body=dyn_body, layout=layout, **kw)


STAGES = ("torque", "assemble", "stages", "tables", "solve", "integrate",
          "reward")
CLOCKS = "\n#define PPI_STAGE_CLOCKS 1\n"


def stage_cycles(env, state, header, n, h, scale):
    """SM cycles of each stage per rollout and substep (torque and reward:
    per step) from the clocked build of ``header``, one launch at N=n,
    H=h."""
    from ppi_tpu_torch.build import load_function
    lib = rk._warp_library(header + CLOCKS)
    fn = rk.load_launch(lib, "warp")
    take = load_function(lib, "ppi_stage_clocks_take", 1, 0, stream=False)
    consts, _, dyn = rk.kernel_operands(env, state)
    staged = rk.stage(*lanes(env, state, n, h, scale), dyn, consts)
    clocks = np.zeros(len(STAGES), np.uint64)
    for _ in range(2):   # the first launch warms up; the second is read
        take(clocks.ctypes.data)
        rk.launch(fn, staged, "warp", (1,))
        torch.cuda.synchronize()
    check = take(clocks.ctypes.data)
    if check:
        raise RuntimeError(f"reading the stage clocks: CUDA error {check}")
    per = [n * h] + [n * h * env.substeps] * 5 + [n * h]
    return {st: float(c) / p for st, c, p in zip(STAGES, clocks, per)}


def study(name, dev):
    env = ENVS[name]()
    (n, h), scale = CANONICAL.get(name, ((128, 30), 0.3))
    state = env.reset(torch.Generator(dev).manual_seed(0), dev)
    consts, _, dyn = rk.kernel_operands(env, state)
    out = {"env": name}

    q0, qd0, acts = lanes(env, state, N_CHECK, H_CHECK, scale)
    got = {lay: rollout(env, state, H_CHECK, lay, 1)(
        q0, qd0, acts, consts=consts, dyn=dyn) for lay in ("lane", "warp")}
    plain = rk.env_plain_rollout(env, state, q0, qd0, acts)
    torch.cuda.synchronize()
    out["warp_equals_lane"] = all(same_bits(a, b) for a, b in
                                  zip(got["warp"], got["lane"]))
    out["warp_equals_plain"] = all(same_bits(a, b) for a, b in
                                   zip(got["warp"], plain))
    out["max_abs_err_plain"] = max(float((a - b).abs().max())
                                   for a, b in zip(got["warp"], plain))

    for nn in (n, 1024):
        q0, qd0, acts = lanes(env, state, nn, h, scale)
        for layout, sizes in (("lane", BLOCKS), ("warp", WARPS)):
            for size in sizes:
                r = rollout(env, state, h, layout, size)
                out[f"{layout}_{size}_ms_N{nn}_H{h}"] = cuda_ms(
                    lambda: r(q0, qd0, acts, consts=consts, dyn=dyn), 3)
    q0, qd0, acts = lanes(env, state, n, h, scale)
    runs = {"lane": rollout(env, state, h, "lane", 128),
            "warp": rollout(env, state, h, "warp", rk.WARPS_PER_BLOCK)}
    out[f"abba_ms_N{n}_H{h}"] = [
        (lay, cuda_ms(lambda: runs[lay](q0, qd0, acts, consts=consts,
                                        dyn=dyn), 10))
        for lay in ("lane", "warp", "warp", "lane")]
    header = rk._warp_header(*rk.body_args(env, state))
    for nn in (n, 1024):
        out[f"cycles_N{nn}_H{h}"] = stage_cycles(env, state, header, nn, h,
                                                 scale)
    action = state.physics.qpos[:env.action_dim] + 0.1
    for layout in ("lane", "warp"):
        r = rollout(env, state, 1, layout, 128 if layout == "lane" else 1)
        q1 = state.physics.qpos[None].contiguous()
        qd1 = state.physics.qvel[None].contiguous()
        a1 = action[None, None].contiguous()
        run1 = (lambda r=r: r(q1, qd1, a1, consts=consts, dyn=dyn))
        run1()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run1()
        torch.cuda.synchronize()
        out[f"{layout}_step_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    return out


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("warp_layout: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print("SM clock now, max: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    names = names or list(CANONICAL)
    headers = {}
    for name in names:
        env = ENVS[name]()
        args = rk.body_args(env, env.reset(torch.Generator().manual_seed(0),
                                           "cpu"))
        headers[(name, "lane")] = rk._env_header(*args)
        headers[(name, "warp")] = rk._warp_header(*args)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2 * len(headers)) as pool:
        libs = {key: pool.submit(rk._library if key[1] == "lane"
                                 else rk._warp_library, text)
                for key, text in headers.items()}
        clocked = [pool.submit(rk._warp_library, text + CLOCKS)
                   for key, text in headers.items() if key[1] == "warp"]
        libs = {key: f.result() for key, f in libs.items()}
        for f in clocked:
            f.result()
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    for key, lib in libs.items():
        ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln
                 or "smem" in ln]
        print(f"ptxas {key[0]} {key[1]}: {' | '.join(ptxas)}", flush=True)
        print(f"sass {key[0]} {key[1]}: {json.dumps(sass_mix(lib))}",
              flush=True)
    ok = True
    for name in names:
        out = study(name, dev)
        out["card"] = smi
        print(json.dumps(out), flush=True)
        ok = ok and out["warp_equals_lane"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
