"""The ball-in-a-cup kernel's two layouts on the card, with a probe.

    python -m ppi_tpu_torch.studies.bic_layout [BUILD ...]

The builds (all three unless named) of the canonical sim
(``BallInCupSim()``: 12 particles, 15 sweeps, the same-step coupling):

  * "thread": the one-thread layout (``csrc/bic_rollout.cu``);
  * "thread_div": its body with every division through ``ppi_div``
    (``bic_kernel.skip_zero_dividends``: a zero dividend skips the
    division, bit for bit), a probe of what the divisions cost it;
  * "warp": the warp layout (``csrc/bic_rollout_warp.cu``) as the main
    path builds it.

In one process on the card: builds, in parallel, each kernel and its
clocked build (the header with ``PPI_BIC_CLOCKS`` defined), and, as each
pair is built, prints its nvcc seconds, ``-Xptxas -v`` summary and SASS
counts (``cuobjdump -sass`` on the library: every instruction of every
function, the IEEE division checks ``FCHK``, the reciprocal and
reciprocal square root ``MUFU`` ops, the calls, the local-memory loads and
stores) and, from the clocked build, the SM cycles a step of each part of
it (lane 0 of every warp, ``clock64`` between the parts; summed over the
launch and divided by the warps that clock and the steps) at N=128 over
250 + 1,000 + 350 steps, the canonical search's shape; then each build
against the thread layout bit for bit at N=1000 over 10 + 20 + 10 steps.
Once "thread" and "warp" are built: the warp layout at 1, 2 and 4
trajectories a block (``WARP_SWEEP``) at both shapes, and the two as the
main path launches them (``bic_kernel.BLOCK`` threads,
``bic_kernel.WARPS`` trajectories a block) with the kernel alone, warmed
by a launch, in turns (thread, warp, warp, thread) at
N=128 over 1,600 steps (``READINGS[0]`` launches a reading) and at N=1000
over 40 steps (``READINGS[1]``). Prints one JSON line with the card's
name and power limit from ``nvidia-smi``. Exits non-zero without a card
or where a build's bits differ from the thread layout's.
"""

import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np
import torch

from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
from ppi_tpu_torch.envs.physics import bic_kernel as bk

# build -> its layout
BUILDS = {"thread": "thread", "thread_div": "thread", "warp": "warp"}
# the builds timed in turns
TIMED = ("thread", "warp")
CLOCKS = "\n#define PPI_BIC_CLOCKS 1\n"
# the parts of a step that each layout's clocked build times (lane 0)
CLOCK_PARTS = {
    "thread": ("arm_1", "string_1", "arm_2", "string_2", "commit"),
    "warp": ("arm_1", "frame_1", "sweeps_1", "contact_reaction_1",
             "arm_2", "frame_2", "sweeps_2", "contact_reaction_2",
             "commit")}
Q_START = (0.0, 0.0, 0.0, 1.5707)
# (N, (stabilize, trajectory, cool-down)): the canonical search's shape
# and chip_smoke.py's check shape
SHAPES = ((128, (250, 1000, 350)), (1000, (10, 20, 10)))
READINGS = (2, 10)
WARP_SWEEP = (1, 2, 4)
# SASS opcodes counted by ``sass_counts``
SASS_OPS = {"division checks (FCHK)": ("FCHK",),
            "reciprocals (MUFU.RCP)": ("MUFU.RCP",),
            "reciprocal square roots (MUFU.RSQ)": ("MUFU.RSQ",),
            "calls (CALL)": ("CALL.REL", "CALL.REL.NOINC", "CALL.ABS",
                             "CALL.ABS.NOINC"),
            "local loads and stores (LDL, STL)": ("LDL", "STL")}


def header(sim, name):
    if name == "thread":
        return bk.generate_bic_header(sim)
    if name == "thread_div":
        return bk.skip_zero_dividends(bk.generate_bic_header(sim))
    return bk.generate_warp_header(sim)


def build(sim, name, clocked):
    t0 = time.perf_counter()
    lib = bk._library(header(sim, name) + (CLOCKS if clocked else ""),
                      layout=BUILDS[name])
    return lib, time.perf_counter() - t0


def ptxas(lib):
    return [ln.strip() for ln in (lib.parent / "build.log").read_text()
            .splitlines() if "registers" in ln or "spill" in ln
            or "stack frame" in ln]


def sass_counts(lib):
    """Instructions of ``lib`` by ``SASS_OPS``, with the total; None where
    cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    ops = [m.group(1) for m in (
        re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                  r"([A-Z][A-Z0-9_.]*)", ln) for ln in text.splitlines()) if m]
    out = {"total": len(ops)}
    for name, names in SASS_OPS.items():
        out[name] = sum(op in names or op.split(".")[0] in names
                        for op in ops)
    return out


def actions(n, horizon, seed, dev):
    """``chip_smoke.bic_actions``: the shoulder and the elbow held about
    the canonical start, random velocities."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, horizon, 4), np.float32)
    a[..., 0] = Q_START[1] + 0.4 * rng.standard_normal((n, 1))
    a[..., 1] = Q_START[3] + 0.4 * rng.standard_normal((n, 1))
    a[..., 2:] = 3.0 * rng.standard_normal((n, horizon, 2))
    return torch.from_numpy(a).to(dev)


class Launch:
    """One build's launch on inputs laid out once: ``self()`` runs the
    kernel into the same outputs."""

    def __init__(self, lib, layout, sim, n, phases, size, dev, seed=40):
        n_stab, horizon, n_cool = phases
        self.fn = bk.load_launch(lib, layout)
        self.q = torch.tensor(Q_START, device=dev)
        self.act = actions(n, horizon, seed, dev).permute(1, 2, 0) \
            .contiguous()
        self.state = torch.empty((sim.layout.size, n), device=dev)
        self.score = torch.empty((2, n), device=dev)
        self.args = (n, horizon, n_stab, n_cool, size)

    def __call__(self):
        err = self.fn(self.q.data_ptr(), self.act.data_ptr(),
                      self.state.data_ptr(), self.score.data_ptr(),
                      *self.args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ball-in-a-cup launch: CUDA error {err}")


def block_size(layout):
    return bk.BLOCK if layout == "thread" else bk.WARPS


def step_cycles(lib, layout, sim, dev):
    """SM cycles a step of each part of ``CLOCK_PARTS[layout]`` on lane 0,
    one launch at the canonical search's shape after a short one."""
    from ppi_tpu_torch.build import load_function
    take = load_function(lib, "ppi_bic_clocks_take", 1, 0, stream=False)
    n, phases = SHAPES[0]
    clocks = np.zeros(len(CLOCK_PARTS[layout]), np.uint64)
    run = Launch(lib, layout, sim, n, phases, block_size(layout), dev)
    run()
    torch.cuda.synchronize()
    if take(clocks.ctypes.data):
        raise RuntimeError("reading the step clocks failed")
    run()
    torch.cuda.synchronize()
    if take(clocks.ctypes.data):
        raise RuntimeError("reading the step clocks failed")
    # the thread layout clocks lane 0 of every warp (32 trajectories); the
    # warp layout lane 0 of every trajectory
    units = (n + 31) // 32 if layout == "thread" else n
    c = clocks.astype(np.float64) / (units * sum(phases))
    out = {k: round(float(v), 1) for k, v in zip(CLOCK_PARTS[layout], c)}
    out["step"] = round(float(c.sum()), 1)
    return out


def reading(fn, launches):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("bic_layout: no CUDA device")
    names = tuple(argv) or tuple(BUILDS)
    for name in names:
        if name not in BUILDS:
            raise SystemExit(f"bic_layout: unknown build {name!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    sim = BallInCupSim()
    out = {"card": smi, "device": torch.cuda.get_device_name(0),
           "ops_per_lane_step": bk.ops_per_lane_step(sim)}
    libs, built, turns_done = {}, {}, False
    timed = [name for name in TIMED if name in names]
    with ThreadPoolExecutor(max_workers=2 * len(names)) as pool:
        futures = {pool.submit(build, sim, name, clocked): (name, clocked)
                   for name in names for clocked in (False, True)}
        for future in as_completed(futures):
            name, clocked = futures[future]
            built[(name, clocked)] = future.result()
            if (name, not clocked) not in built:
                continue
            libs[name] = built[(name, False)][0]
            out.update(report(sim, name, built, dev))
            for other in ([n for n in libs if n != "thread"]
                          if name == "thread" else
                          [name] if "thread" in libs else []):
                out[f"bits_equal_{other}_N{SHAPES[1][0]}"] = bits(
                    sim, libs["thread"], libs[other], other, dev)
            if timed and not turns_done and all(n in libs for n in timed):
                turns_done = True
                out.update(timings(sim, {n: libs[n] for n in timed}, dev))
    print(json.dumps(out), flush=True)
    return 0


def report(sim, name, built, dev):
    """A build pair's nvcc seconds, ptxas lines, SASS counts and step
    cycles."""
    out = {}
    for clocked in (False, True):
        lib, secs = built[(name, clocked)]
        key = f"{name}{'_clocked' if clocked else ''}"
        out[f"build_{key}"] = {
            "lines": len(header(sim, name).splitlines()), "nvcc_s": secs,
            "ptxas": ptxas(lib), "sass": sass_counts(lib)}
        print(f"build {key}: {json.dumps(out[f'build_{key}'])}", flush=True)
    out[f"cycles_{name}"] = step_cycles(built[(name, True)][0], BUILDS[name],
                                        sim, dev)
    print(f"cycles a step, {name} (lane 0, N={SHAPES[0][0]}): "
          f"{json.dumps(out[f'cycles_{name}'])}", flush=True)
    return out


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def bits(sim, thread_lib, lib, name, dev):
    """``name``'s build against the thread layout's at the check's shape,
    bit for bit; exits where they differ."""
    n, phases = SHAPES[1]
    runs = [Launch(lib_, BUILDS[nm], sim, n, phases,
                   block_size(BUILDS[nm]), dev, seed=39)
            for lib_, nm in ((thread_lib, "thread"), (lib, name))]
    for run in runs:
        run()
    torch.cuda.synchronize()
    same = (same_bits(runs[0].state, runs[1].state)
            and same_bits(runs[0].score, runs[1].score))
    print(f"{name} vs thread at N={n}, {phases} steps: bit for bit {same}",
          flush=True)
    if not same:
        raise SystemExit(f"bic_layout: {name}'s bits differ from the "
                         "thread layout's")
    return same


def timings(sim, libs, dev):
    """The warp sweep and the turns at both shapes."""
    out = {}
    order = list(libs)
    for (n, phases), launches in zip(SHAPES, READINGS):
        key = f"N{n}_steps{sum(phases)}"
        if "warp" in libs:
            sweep = {}
            for warps in WARP_SWEEP:
                run = Launch(libs["warp"], "warp", sim, n, phases, warps, dev)
                run()
                sweep[warps] = reading(run, launches)
            out[f"warp_sweep_ms_{key}"] = sweep
            print(f"warp layout at 1 / 2 / 4 trajectories a block, {key}: "
                  f"{json.dumps(sweep)}", flush=True)
        runs = {name: Launch(libs[name], BUILDS[name], sim, n, phases,
                             block_size(BUILDS[name]), dev)
                for name in order}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        turns = [[name, reading(runs[name], launches)]
                 for name in order + order[::-1]]
        out[f"turns_ms_{key}"] = turns
        print(f"turns, {key}: {json.dumps(turns)}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
