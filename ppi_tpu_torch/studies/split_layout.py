"""The rollout kernel's split layout against the lane and warp layouts.

    python -m ppi_tpu_torch.studies.split_layout [ENV ...]

For each env (door-v0 and hammer-v0 unless named; relocate-v0, cheetah,
walker2d, walker~walk, humanoid-standup and pen-v0-hand take the subtree
partition, fetch-push, hopper, pen-v0, reacher and finger~spin the chain
cut, ``scalar_split_partition``), in one process
on the card: first the host seconds to generate its bodies (the lane
header; the split generator's search; the split header through an empty
cache and through the filled one, ``split_layout.cached_body``; the lane
header again); then builds, in parallel, the lane layout
(``csrc/rollout.cu``), the warp layout (``csrc/rollout_warp.cu``, its
existing warp header), the split layout (``csrc/rollout_split.cu``) as the
generator chooses it (for a partitioned env, the partition; its
list-scheduled body too, "list", and for a chain-cut env its subtree
partition, "subtree", where that plans) and forced to 2, 3 and 4
list-scheduled streams, and the clocked builds (the warp layout's
``PPI_STAGE_CLOCKS``, the split layout's ``PPI_PHASE_CLOCKS``); prints each build's ``-Xptxas
-v`` summary and the split generator's report (streams, phases, slots,
carry registers, the model's cost a step for each number of streams; for
a partition its groups, solve warp, replication, exchanged values and
shared loads, and the model's cost of every choice it tried, and for the
chain cut each cut's cheapest choice, ``cost_by_cut``). Then: the
split layout against the lane layout bit for bit at N=257 (ragged), H=3
with a NaN lane; CUDA-event times of the main path's whole call in turns
(lane, warp, split, split, warp, lane) at the env's canonical shape
(``SHAPES``: N=64/H=30 for door-v0 and hammer-v0, N=256/H=20 for
relocate-v0 and fetch-push, N=256/H=30 for cheetah, walker2d,
humanoid-standup and hopper, N=128/H=25 for walker~walk, N=96/H=15 for
pen-v0-hand and pen-v0, N=64/H=20 for reacher, N=128/H=20 for
finger~spin), and lane, split, split,
lane at the larger shapes (door-v0 and hammer-v0 at N=1024/H=160, at
N=4096/H=160, a 4-rank shard of N=16384, and at N=16384/H=160; pen-v0 at
N=1024/H=160); the other split builds at the canonical shape; the warmed
turns there (``warmed_turns``: after 0.5 s of launches, 200 launches a
reading, every candidate body with the kernel alone, lane, the list plans
forced to 2, 3 and 4 warps, the split plan, a chain-cut env's subtree
partition, and back; the lane body and the split plan also through the
whole call, whose gap to the kernel alone is the wrapper's share; the
lane's two readings' spread and whether the fastest candidate beats the
lane by more than it); the real
step (N=1, H=1, host clock over 20 launches) in all three layouts; the
warp layout's SM cycles a stage and the split layout's a phase at the
canonical shape (lane 0 of each warp: its work, then work and wait to
the barrier's end, per group and substep, the reward's phases and the
torque per step); and the split kernel's blocks an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); for door-v0, the
canonical episode (``make mpc-lbps``, N=64, H=30, T=250, seed 0) in ten
pairs of the split and lane layouts (split, lane, lane, split, ...), each
with its wall, return and launches. Prints one JSON line per env with the
card's name and power limit from ``nvidia-smi``. Exits non-zero without a card,
where the split layout's bits differ from the lane layout's, or where the
episode's returns differ between the layouts.
"""

import functools
import json
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ppi_tpu_torch.build import LAUNCHES, load_function
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.runners.run_mpc import ENVS
from ppi_tpu_torch.studies import warp_layout as wl

ENV_NAMES = ("door-v0", "hammer-v0")
_DOOR_SHAPES = ((64, 30), (1024, 160), (4096, 160), (16384, 160))
# each env's shapes, its canonical one (where its episodes run) first
SHAPES = {"door-v0": _DOOR_SHAPES, "hammer-v0": _DOOR_SHAPES,
          "relocate-v0": ((256, 20),), "cheetah": ((256, 30),),
          "walker2d": ((256, 30),), "humanoid-standup": ((256, 30),),
          "pen-v0-hand": ((96, 15),), "walker~walk": ((128, 25),),
          "fetch-push": ((256, 20),), "hopper": ((256, 30),),
          "reacher": ((64, 20),), "finger~spin": ((128, 20),),
          "pen-v0": ((96, 15), (1024, 160))}
FORCED = (2, 3, 4)
# the warmed, kernel-only turns (``warmed_turns``): the host seconds of
# launches that warm the card before the first reading, and the launches
# a reading
WARM_S = 0.5
READING = 200
PHASE_CLOCKS = "\n#define PPI_PHASE_CLOCKS 1\n"
# the canonical door-v0 episode (make mpc-lbps), timed in turns
DOOR_EPISODE = ["Lbps", "door-v0", "SquaredExponentialKernel", "--delta",
                "0.9", "--n-iters", "2", "--anneal", "0.5", "--lengthscale",
                "0.08", "--horizon", "30", "--timesteps", "250",
                "--n-warmstart-iters", "50", "--seed", "0", "--device",
                "cuda", "MonteCarlo", "--n-samples", "64"]
EPISODE_PAIRS = 10


class Split:
    """A build of a split header (clocked or not), its generator's report
    and its launch on lane-major tensors."""

    def __init__(self, header, report, clocked=False):
        self.header, self.report = header, report
        self.lib = rk._split_library(header + (PHASE_CLOCKS if clocked
                                               else ""))

    def load(self):
        occ = load_function(self.lib, "ppi_rollout_split_occupancy", 1, 0,
                            stream=False)
        blocks = np.zeros(1, np.int32)
        if occ(blocks.ctypes.data):
            raise RuntimeError("occupancy query failed")
        self.blocks_per_sm = int(blocks[0])
        return self

    def runner(self, q0, qd0, acts, consts, dyn):
        """A callable that launches this build on the (N, nq) lanes and
        (N, H, d_a) actions laid out once (``rk.stage``); it returns
        (rewards, qf, qdf)."""
        return functools.partial(rk.launch, rk.load_launch(self.lib, "split"),
                                 rk.stage(q0, qd0, acts, dyn, consts),
                                 "split")


def phase_cycles(env, state, split, n, h):
    """SM cycles a group of each phase and stream (work; work and wait)
    from the clocked build, one launch at N=n, H=h after a warm-up."""
    take = load_function(split.lib, "ppi_phase_clocks_take", 1, 0,
                         stream=False)
    consts, _, dyn = rk.kernel_operands(env, state)
    run = split.runner(*wl.lanes(env, state, n, h, 0.3), consts, dyn)
    rep = split.report
    k, ps, pr = rep["streams"], rep["substep_phases"], rep["reward_phases"]
    clocks = np.zeros((ps + pr + 1, k, 2), np.uint64)
    for _ in range(2):
        take(clocks.ctypes.data)
        run()
        torch.cuda.synchronize()
    if take(clocks.ctypes.data):
        raise RuntimeError("reading the phase clocks failed")
    groups = (n + 31) // 32
    per = np.array([groups * h * env.substeps] * ps + [groups * h] * (pr + 1),
                   np.float64)
    c = clocks.astype(np.float64) / per[:, None, None]
    return {"substep_work": c[:ps, :, 0].round(1).tolist(),
            "substep_wall": c[:ps, 0, 1].round(1).tolist(),
            "reward_work": c[ps:ps + pr, :, 0].round(1).tolist(),
            "reward_wall": c[ps:ps + pr, 0, 1].round(1).tolist(),
            "torque_and_latch": c[-1, :, 0].round(1).tolist(),
            "substep_total": float(c[:ps, 0, 1].sum()),
            "reward_total": float(c[ps:ps + pr, 0, 1].sum())}


def cost_by_cut(report):
    """The chain cut's cheapest choice for each cut it searched: the model's
    cost where one laid out, else the lowest bound it was skipped on."""
    part = report.get("partition") or {}
    if part.get("mode") != "chain":
        return None
    laid, bounds = {}, {}
    for key, cost in part["cost_by_choice"].items():
        cut = key.split("_solve")[0]
        if not isinstance(cost, str):
            laid[cut] = min(cost, laid.get(cut, cost))
        elif cost.startswith("pruned: bound "):
            bound = float(cost.split()[-1])
            bounds[cut] = min(bound, bounds.get(cut, bound))
    return {cut: laid[cut] if cut in laid else f"bound {bounds[cut]}"
            for cut in {**bounds, **laid}}


def generation_s(args, partition):
    """Host seconds to generate one body: the lane header, the split
    generator's search (``generate_split``), the split header through an
    empty cache and through the filled one, and the lane header again."""
    cache = rk.SPLIT_CACHE
    rk.SPLIT_CACHE = cache.parent / "split_study"
    shutil.rmtree(rk.SPLIT_CACHE, ignore_errors=True)
    out = {}
    split = {"partition": partition}
    try:
        for what, fn, kw in (("lane", rk.generate_env_header, {}),
                             ("split_search", rk.generate_split, split),
                             ("split_cache_miss", rk.generate_split_header,
                              split),
                             ("split_cache_hit", rk.generate_split_header,
                              split),
                             ("lane_again", rk.generate_env_header, {})):
            t0 = time.perf_counter()
            fn(*args, **kw)
            out[what] = time.perf_counter() - t0
    finally:
        shutil.rmtree(rk.SPLIT_CACHE, ignore_errors=True)
        rk.SPLIT_CACHE = cache
    return out


def episode_walls():
    """The canonical door-v0 episode in ``EPISODE_PAIRS`` pairs of the split
    and the lane layout, the first layout of a pair alternating (split,
    lane, lane, split, ...), the split body's generator result cached first (as
    in any process after the first): [layout, wall s, return, success,
    launches of that layout] a run."""
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.runners import run_mpc
    door = Door()
    rk.generate_split_header(*rk.body_args(door, door.reset(
        torch.Generator().manual_seed(0), "cpu")))
    saved = Door.__dict__["scalar_kernel_layout"]
    out = []
    try:
        for i in range(EPISODE_PAIRS):
            for lay in (("split", "lane") if i % 2 == 0 else
                        ("lane", "split")):
                Door.scalar_kernel_layout = lay
                args = run_mpc.build_parser().parse_args(DOOR_EPISODE)
                LAUNCHES.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ret, success, _ = run_mpc.main(args)
                torch.cuda.synchronize()
                out.append([lay, time.perf_counter() - t0, ret,
                            bool(success), LAUNCHES[rk.LAUNCH_KEYS[lay]]])
    finally:
        Door.scalar_kernel_layout = saved
    return out


def rollout(env, state, h, layout):
    return rk.env_rollout(env, state, h, layout=layout)


def same(a, b):
    return all(wl.same_bits(x, y) for x, y in zip(a, b))


def warm(fn, seconds=WARM_S):
    """Launches of ``fn`` for ``seconds`` of the host's clock, 50 between
    synchronizations: the card at its working clock before a reading.
    Returns the launches."""
    t0, launches = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        launches += 50
    return launches


def warmed_turns(env, state, splits, n, h):
    """Each candidate body at N=n, H=h timed with the kernel alone (the
    main path's ``run.launch`` on what its ``run.stage`` laid out once, or
    ``Split.runner`` for a forced plan), and the lane body and the routed
    split plan also through the whole ``run(...)`` call of the main path
    (its checks, three layout copies and three allocations), ``READING``
    launches a reading, after ``WARM_S`` host seconds of the lane kernel's
    launches; turns lane, the list plans forced to each of ``FORCED``
    warps, the split plan ("chain" or "subtree" where it is a partition),
    the subtree partition of a chain-cut env, and the same in reverse. The bar: the lane body's two
    kernel-only readings within 3%. A candidate wins where its mean
    kernel-only time beats the lane body's by more than the lane's own
    spread (the difference of its two readings)."""
    consts, _, dyn = rk.kernel_operands(env, state)
    q0, qd0, acts = wl.lanes(env, state, n, h, 0.3)
    routed = rk.split_partition(env) or "list"
    runs = {"lane": rollout(env, state, h, "lane"),
            routed: rollout(env, state, h, "split")}

    def alone(r):
        return functools.partial(r.launch, r.stage(q0, qd0, acts,
                                                   consts=consts, dyn=dyn))
    kernel = {"lane": alone(runs["lane"]),
              **{f"list-{k}": splits[k].runner(q0, qd0, acts, consts, dyn)
                 for k in FORCED},
              routed: alone(runs[routed])}
    if "subtree" in splits:
        kernel["subtree"] = splits["subtree"].runner(q0, qd0, acts, consts,
                                                     dyn)
    call = {label: (lambda r=r: r(q0, qd0, acts, consts=consts, dyn=dyn))
            for label, r in runs.items()}
    for fn in (*kernel.values(), *call.values()):   # load every build
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmed = warm(kernel["lane"])
    warm_s = time.perf_counter() - t0
    order = list(kernel)
    turns = [[label, wl.cuda_ms(kernel[label], READING, 0),
              wl.cuda_ms(call[label], READING, 0) if label in call
              else None]
             for label in order + order[::-1]]
    kern = {label: [t[1] for t in turns if t[0] == label] for label in order}
    full = {label: [t[2] for t in turns if t[0] == label] for label in call}
    mean = {label: float(np.mean(v)) for label, v in kern.items()}
    lane = kern["lane"]
    spread = abs(lane[0] - lane[1])
    best = min((label for label in order if label != "lane"), key=mean.get)
    return {"warm_launches": warmed, "warm_s": warm_s,
            "launches_a_reading": READING,
            "turns_kernel_whole_ms": turns, "kernel_ms": mean,
            "whole_ms": {label: float(np.mean(v))
                         for label, v in full.items()},
            "gap_ms": {label: float(np.mean(full[label]) - mean[label])
                       for label in call},
            "lane_spread": spread / min(lane),
            "meets_bar": spread / min(lane) <= 0.03,
            "fastest": best,
            "wins": mean["lane"] - mean[best] > spread}


def study(name, dev, splits):
    env = ENVS[name]()
    state = env.reset(torch.Generator(dev).manual_seed(0), dev)
    consts, _, dyn = rk.kernel_operands(env, state)
    out = {"env": name}
    chosen = splits[None]
    out["report"] = {key: value for key, value in chosen.report.items()
                     if not key.endswith("plan")}
    out["cost_by_cut"] = cost_by_cut(chosen.report)
    out["blocks_per_sm"] = {str(k): s.blocks_per_sm
                            for k, s in splits.items()}

    q0, qd0, acts = wl.lanes(env, state, wl.N_CHECK, wl.H_CHECK, 0.3)
    q0[5] = torch.nan
    got = {lay: rollout(env, state, wl.H_CHECK, lay)(
        q0, qd0, acts, consts=consts, dyn=dyn)
        for lay in ("lane", "warp", "split")}
    plain = rk.env_plain_rollout(env, state, q0, qd0, acts)
    torch.cuda.synchronize()
    out["split_equals_lane"] = same(got["split"], got["lane"])
    out["split_equals_plain"] = same(got["split"], plain)
    out["warp_equals_lane"] = same(got["warp"], got["lane"])

    shapes = SHAPES.get(name, _DOOR_SHAPES[:1])
    n0, h0 = shapes[0]
    for n, h in shapes:
        q0, qd0, acts = wl.lanes(env, state, n, h, 0.3)
        runs = {lay: rollout(env, state, h, lay)
                for lay in ("lane", "warp", "split")}
        first = (n, h) == (n0, h0)
        order = (("lane", "warp", "split", "split", "warp", "lane")
                 if first else ("lane", "split", "split", "lane"))
        iters = 20 if first else 3
        out[f"turns_ms_N{n}_H{h}"] = [
            [lay, wl.cuda_ms(lambda: runs[lay](q0, qd0, acts, consts=consts,
                                               dyn=dyn), iters)]
            for lay in order]
        if first:
            out[f"split_by_streams_ms_N{n}_H{h}"] = {
                str(k): wl.cuda_ms(s.runner(q0, qd0, acts, consts, dyn),
                                   iters)
                for k, s in splits.items() if k is not None and k != "clk"}
    out[f"warmed_N{n0}_H{h0}"] = warmed_turns(env, state, splits, n0, h0)
    action = state.physics.qpos[:env.action_dim] + 0.1
    q1 = state.physics.qpos[None].contiguous()
    qd1 = state.physics.qvel[None].contiguous()
    a1 = action[None, None].contiguous()
    for lay in ("lane", "warp", "split"):
        r = rollout(env, state, 1, lay)
        r(q1, qd1, a1, consts=consts, dyn=dyn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            r(q1, qd1, a1, consts=consts, dyn=dyn)
        torch.cuda.synchronize()
        out[f"{lay}_step_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    header = rk._warp_header(*rk.body_args(env, state))
    out[f"warp_stage_cycles_N{n0}_H{h0}"] = wl.stage_cycles(
        env, state, header, n0, h0, 0.3)
    out[f"split_phase_cycles_N{n0}_H{h0}"] = phase_cycles(
        env, state, splits["clk"], n0, h0)
    return out


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("split_layout: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    names = names or list(ENV_NAMES)
    gen = {}
    for name in names:
        env = ENVS[name]()
        gen[name] = generation_s(rk.body_args(env, env.reset(
            torch.Generator().manual_seed(0), "cpu")), rk.split_partition(env))
        print(f"generation {name} (host s): {json.dumps(gen[name])}",
              flush=True)
    jobs = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=16) as pool:
        for name in names:
            env = ENVS[name]()
            args = rk.body_args(env, env.reset(
                torch.Generator().manual_seed(0), "cpu"))
            jobs[(name, "lane")] = pool.submit(rk._library,
                                               rk._env_header(*args))
            warp = rk._warp_header(*args)
            jobs[(name, "warp")] = pool.submit(rk._warp_library, warp)
            jobs[(name, "warp_clk")] = pool.submit(rk._warp_library,
                                                   warp + wl.CLOCKS)
            partition = rk.split_partition(env)
            chosen = rk.generate_split(*args, partition=partition)
            made = {None: chosen}
            listed = chosen if partition is None else rk.generate_split(*args)
            if partition is not None:
                made["list"] = listed
            if partition == "chain":
                try:
                    made["subtree"] = rk.generate_split(*args,
                                                        partition="subtree")
                except ValueError as err:   # a chain: no subtree partition
                    print(f"{name}: no subtree partition: {err}", flush=True)
            for k in FORCED:   # the list's number of warps is built once
                made[k] = (listed if k == listed[1]["streams"]
                           else rk.generate_split(*args, streams=k))
            for k, (header, report) in made.items():
                jobs[(name, k)] = pool.submit(Split, header, report)
            jobs[(name, "clk")] = pool.submit(Split, *chosen, True)
        done = {key: f.result() for key, f in jobs.items()}
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)
    for (name, what), res in done.items():
        lib = res.lib if isinstance(res, Split) else res
        ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text()
                 .splitlines() if "registers" in ln or "spill" in ln]
        print(f"ptxas {name} {what}: {' | '.join(ptxas)}", flush=True)
    ok = True
    for name in names:
        splits = {what: res.load() for (nm, what), res in done.items()
                  if nm == name and isinstance(res, Split)}
        out = study(name, dev, splits)
        out["generation_s"] = gen[name]
        if name == "door-v0":
            out["episode_turns"] = episode_walls()
            ok = ok and len({r[2] for r in out["episode_turns"]}) == 1
        out["card"] = smi
        print(json.dumps(out), flush=True)
        ok = ok and out["split_equals_lane"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
