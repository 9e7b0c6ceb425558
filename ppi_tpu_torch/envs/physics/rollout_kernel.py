"""The whole-rollout CUDA kernel: generator, build, wrapper, plain version.

Counterpart of ``ppi_tpu/envs/physics/pallas_rollout.py``. The JAX package
traces the env's scalar program into a Pallas body; here the same program
runs over ``scalar_math.Sym`` and emits the per-env body of a hand-written
CUDA skeleton (``ppi_tpu_torch/csrc/rollout.cu``):

  * ``env_torque``  -- the env's ``scalar_torque``;
  * ``env_substep`` -- one ``engine_soa.substep_soa``;
  * ``env_reward``  -- the env's ``scalar_reward``, which may take the
    step's raw action and per-episode reward constants;
  * ``env_project`` -- the env's ``scalar_project``, only for an env that
    has one (the header then defines ``PPI_PROJECT``).

That is the lane layout: one rollout a thread. The warp layout
(``csrc/rollout_warp.cu``, one rollout a warp) replaces ``env_substep`` by
lane 0's ``env_assemble`` and ``env_integrate`` around generated stages,
tables and a Gauss-Jordan solve that spread the rest of the substep over
the warp's lanes (``warp_layout``; where the mass matrix's leading
pivots fold to constants, the solve's first steps come from tables); an
env with ``scalar_kernel_layout = "warp"`` (door-v0-hand, door-v0-adroit,
relocate-v0-adroit, hammer-v0-adroit, hammer-v0-hand, relocate-v0-hand,
pen-v0-adroit, fetch-pick) plans and steps through it. The split layout
(``csrc/rollout_split.cu``, 32 rollouts a block) schedules the lane
layout's own substep and reward over the block's warps, one stream a warp,
values crossing streams through shared memory between barriers
(``split_layout``); an env with ``scalar_kernel_layout = "split"``
(door-v0, relocate-v0, cheetah, walker2d, walker~walk, humanoid-standup,
pen-v0-hand, fetch-push, hopper, pen-v0, reacher) plans and steps through
it, and one with ``scalar_split_partition = "subtree"`` (relocate-v0,
cheetah, walker2d, walker~walk, humanoid-standup, pen-v0-hand) has its
split body's substep partitioned by the body tree
(``split_layout.plan_partition``), one with ``"chain"`` (fetch-push,
hopper, pen-v0, reacher) partitioned with its heaviest chain of bodies cut
into segments over the free warps. All three give the same
values bit for bit; every body of the runner has a lane and a warp body,
and every one whose split plan fits a block's shared memory a split body.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/<hash of sources and flags>/`` and bound with ``ctypes``
(``ppi_tpu_torch/build.py``).

The wrapper returned by ``make_rollout`` takes the plain version (the same
scalar program, eagerly over torch tensors) for CPU tensors only. For CUDA
tensors it launches the kernel or raises; ``LAUNCHES["rollout"]``,
``LAUNCHES["rollout_warp"]`` and ``LAUNCHES["rollout_split"]`` (the shared
counter of ``ppi_tpu_torch.build``) count the three layouts' launches.

Env contract (duck-typed, as ``ppi_tpu``'s): ``env._model``, ``env.dt``,
``env.substeps``, ``env.action_dim``, ``env.scalar_torque(m, q, qd, act)``,
``env.scalar_reward(m, q, qd[, act][, consts])``, and optionally:

  * ``env.scalar_dyn_body`` with ``env.scalar_dyn_consts(state) -> (3,)``,
    the sampled body offset (door-v0's frame);
  * ``env.scalar_reward_consts(state) -> (k,)``, the per-episode reward
    constants (pen-v0's and relocate-v0's sampled goal);
  * ``env.scalar_reward_takes_action = True``: the reward takes the step's
    raw action, before any clip (cheetah's control cost);
  * ``env.scalar_project(m, q_prev, q, qd) -> (q, qd)``: a kinematic
    projection after each control step's substeps, with ``q_prev`` the
    whole pre-step coordinate tuple (the hand door scenes' bolt clamp).

``kernel_step`` runs one real env step as one launch (H=1); ``plain_step``
is its eager version and ``env_step`` chooses between them by the state's
device (the env also carries ``env._soa``, its ``SoaModel``).
"""

import dataclasses
import functools
from pathlib import Path

import torch

from ppi_tpu_torch.build import (
    BUILD_ROOT, LAUNCHES, build_library, load_function)
from ppi_tpu_torch.envs.base import risk_aggregate
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics import split_layout, warp_layout
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel, substep_soa
from ppi_tpu_torch.parallel.mesh import gather_costs, shard_bounds

# ---- code generation -------------------------------------------------------

def call_reward(reward_fn, m, q, qd, act, consts, reward_takes_action):
    """``reward_fn(m, q, qd[, act][, consts])``, as the Pallas body calls
    it: the raw action tuple ahead of the constants tuple."""
    extra = (act,) if reward_takes_action else ()
    if consts is not None:
        extra = extra + (consts,)
    return reward_fn(m, q, qd, *extra)


def generate_env_header(model, dt: float, substeps: int, action_dim: int,
                        torque_fn, reward_fn, dyn_body=None,
                        n_consts: int = 0, reward_takes_action: bool = False,
                        project_fn=None) -> str:
    """C source of the per-env body (``env_body.h``) for the skeleton.

    Runs the scalar program over symbols; every model constant is folded
    and written as an exact f32 literal, the sampled body offset (when
    ``dyn_body`` is set) is read from ``dyn[0..2]`` and the reward
    constants from ``consts[0..n_consts-1]``. Only with ``project_fn``
    does the header define ``PPI_PROJECT`` and ``env_project``.
    Deterministic: the same inputs give the same text, which keys the
    build cache."""
    return _generate(model, dt, substeps, action_dim, torque_fn, reward_fn,
                     dyn_body, n_consts, reward_takes_action, project_fn)[0]


def ops_per_lane_step(model, dt: float, substeps: int, action_dim: int,
                      torque_fn, reward_fn, dyn_body=None, n_consts: int = 0,
                      reward_takes_action: bool = False,
                      project_fn=None) -> int:
    """f32 operations one lane's control step emits (``Emitter.ops``):
    torque + ``substeps`` x substep + projection + reward, plus the NaN
    latch's 2 nq finiteness tests. Times N x H, it is the work the rollout
    kernel must do, which bounds its time from below."""
    ops = _generate(model, dt, substeps, action_dim, torque_fn, reward_fn,
                    dyn_body, n_consts, reward_takes_action, project_fn)[1]
    return (ops["torque"] + substeps * ops["substep"] + ops["project"]
            + ops["reward"] + 2 * model.nq)


def generate_warp_header(model, dt: float, substeps: int, action_dim: int,
                         torque_fn, reward_fn, dyn_body=None,
                         n_consts: int = 0, reward_takes_action: bool = False,
                         project_fn=None) -> str:
    """C source of the warp layout's per-env body (``env_warp.h``) for
    ``csrc/rollout_warp.cu``: ``generate_env_header``'s torque, reward and
    projection, and in place of ``env_substep`` the stages and tables of
    ``warp_layout.generate_stages``. Deterministic, as the lane header."""
    return _generate(model, dt, substeps, action_dim, torque_fn, reward_fn,
                     dyn_body, n_consts, reward_takes_action, project_fn,
                     layout="warp")[0]


def generate_split(model, dt: float, substeps: int, action_dim: int,
                   torque_fn, reward_fn, dyn_body=None, n_consts: int = 0,
                   reward_takes_action: bool = False, project_fn=None,
                   partition=None, streams=None):
    """(C source, report) of the split layout's per-env body
    (``env_split.h``) for ``csrc/rollout_split.cu``:
    ``generate_env_header``'s torque and projection, and the substep and
    the reward scheduled over the warps of a group by ``split_layout``:
    list-scheduled (``streams`` forces their number, for a study), or with
    ``partition="subtree"`` the substep partitioned by the model's body
    tree (``split_layout.plan_partition``), with ``partition="chain"``
    partitioned with its heaviest chain of bodies cut into segments. The
    report is
    ``split_layout.plan_body``'s: the streams, phases, slots and carry
    registers chosen, the model's cost a step for each number of streams,
    the substep's and the reward's plans and the partition's report.
    Deterministic, as the lane header; the search runs at every call
    (a second or two)."""
    text, _, info = _generate_body(
        model, dt, substeps, action_dim, torque_fn, reward_fn, dyn_body,
        n_consts, reward_takes_action, project_fn, "split", streams, True,
        partition)
    return text, info


def generate_split_header(model, dt: float, substeps: int, action_dim: int,
                          torque_fn, reward_fn, dyn_body=None,
                          n_consts: int = 0, reward_takes_action: bool = False,
                          project_fn=None, partition=None) -> str:
    """``generate_split``'s C source, the generator's choice read from
    ``SPLIT_CACHE`` after its first search for the body
    (``split_layout.cached_body``)."""
    return _generate_body(model, dt, substeps, action_dim, torque_fn,
                          reward_fn, dyn_body, n_consts, reward_takes_action,
                          project_fn, "split", partition=partition)[0]


def _generate(model, dt, substeps, action_dim, torque_fn, reward_fn,
              dyn_body, n_consts, reward_takes_action, project_fn,
              layout="lane"):
    """(header text, {function: emitted f32 ops}) of ``layout``'s body;
    the ops are counted for the lane layout only (the warp and split
    layouts do the same work)."""
    return _generate_body(model, dt, substeps, action_dim, torque_fn,
                          reward_fn, dyn_body, n_consts, reward_takes_action,
                          project_fn, layout)[:2]


def _generate_body(model, dt, substeps, action_dim, torque_fn, reward_fn,
                   dyn_body, n_consts, reward_takes_action, project_fn,
                   layout, streams=None, report=False, partition=None):
    """``_generate``'s (text, ops) and, with ``report``, the split layout's
    report (else None; without it the split body comes through
    ``SPLIT_CACHE``); ``partition`` as ``generate_split``'s."""
    if partition not in (None, "subtree", "chain"):
        raise ValueError(f"partition must be None, 'subtree' or 'chain', "
                         f"not {partition!r}")
    m = SoaModel(model)
    nq, h = m.nq, dt / substeps

    def prologue(em, with_act=False, with_tau=False):
        q = tuple(em.input(f"q_{j}", f"q[{j}]") for j in range(nq))
        qd = tuple(em.input(f"qd_{j}", f"qd[{j}]") for j in range(nq))
        mm = m
        if dyn_body is not None:
            mm = m.with_body_offset(dyn_body, tuple(
                em.input(f"dyn_{k}", f"dyn[{k}]") for k in range(3)))
        extra = ()
        if with_act:
            extra = tuple(em.input(f"a_{k}", f"act[{k}]")
                          for k in range(action_dim))
        if with_tau:
            extra = tuple(em.input(f"tau_{j}", f"tau[{j}]")
                          for j in range(nq))
        return mm, q, qd, extra

    em = sm.Emitter()
    mm, q, qd, act = prologue(em, with_act=True)
    tau = torque_fn(mm, q, qd, act)
    ops = {"torque": em.ops}
    torque = sm.c_function(
        "void env_torque(const float* q, const float* qd, const float* act, "
        "const float* dyn, float* tau)",
        em, [(f"tau[{j}]", tau[j]) for j in range(nq)])

    if layout in ("lane", "split"):
        em_sub = em = sm.Emitter()
        mm, q, qd, tau = prologue(em, with_tau=True)
        q2, qd2 = substep_soa(mm, q, qd, tau, h)
        ops["substep"] = em.ops
        stages = [] if layout == "split" else [sm.c_function(
            "void env_substep(float* q, float* qd, const float* tau, "
            "const float* dyn)",
            em, [(f"q[{j}]", q2[j]) for j in range(nq)]
            + [(f"qd[{j}]", qd2[j]) for j in range(nq)])]
        warp_defines, tables = [], []
    else:
        warp_defines, tables, stages = warp_layout.generate_stages(
            m, prologue, h, action_dim, project_fn is not None)

    em = sm.Emitter()
    mm, q, qd, act = prologue(em, with_act=reward_takes_action)
    consts = (tuple(em.input(f"c_{k}", f"consts[{k}]")
                    for k in range(n_consts)) if n_consts else None)
    r = call_reward(reward_fn, mm, q, qd, act, consts, reward_takes_action)
    ops["reward"] = em.ops
    info = None
    if layout == "split":
        tree = split_layout.Tree.of(m) if partition else None
        if report:
            info = split_layout.plan_body(em_sub, q2, qd2, em, r, nq,
                                          substeps, ops["torque"], streams,
                                          tree, partition)
            split_defines, reward = split_layout.emit_body(info)
        else:
            split_defines, reward = split_layout.cached_body(
                SPLIT_CACHE, em_sub, q2, qd2, em, r, nq, substeps,
                ops["torque"], tree, partition)
        warp_defines = warp_defines + split_defines
    else:
        em.lines.append(f"  return {sm._operand(r)};")
        reward = sm.c_function(
            "float env_reward(const float* q, const float* qd, "
            "const float* act, const float* dyn, const float* consts)",
            em, [])

    defines = [f"#define PPI_NQ {nq}", f"#define PPI_DA {action_dim}",
               f"#define PPI_SUBSTEPS {substeps}",
               f"#define PPI_NCONSTS {n_consts}"]
    functions = [torque, *stages, reward]
    ops["project"] = 0
    if project_fn is not None:
        em = sm.Emitter()
        mm, q, qd, _ = prologue(em)
        q_prev = tuple(em.input(f"qp_{j}", f"q_prev[{j}]")
                       for j in range(nq))
        q2, qd2 = project_fn(mm, q_prev, q, qd)
        ops["project"] = em.ops
        # only the coordinates the projection changed are written back
        functions.append(sm.c_function(
            "void env_project(const float* q_prev, float* q, float* qd, "
            "const float* dyn)", em,
            [(f"q[{j}]", q2[j]) for j in range(nq) if q2[j] is not q[j]]
            + [(f"qd[{j}]", qd2[j]) for j in range(nq)
               if qd2[j] is not qd[j]]))
        defines.append("#define PPI_PROJECT 1")

    skeleton = {"lane": "rollout.cu", "warp": "rollout_warp.cu",
                "split": "rollout_split.cu"}[layout]
    text = "\n".join([
        f"/* Per-env body of ppi_tpu_torch/csrc/{skeleton}, generated by",
        "   ppi_tpu_torch/envs/physics/rollout_kernel.py from the scalar",
        "   physics program. Do not edit. */",
        *defines, *warp_defines,
        "",
        sm.C_HELPERS,
        *tables,
        *functions])
    return text, ops, info


# the MPC agent builds an objective per control step: generate each env's
# body once (model and bound methods hash by identity and value). Unbounded:
# one entry per env of the registry a process touches, none ever evicted
_env_header = functools.cache(generate_env_header)
_warp_header = functools.cache(generate_warp_header)
_split_header = functools.cache(generate_split_header)
# the split generator's results (``split_layout.cached_body``), one file a
# body, beside the builds
SPLIT_CACHE = BUILD_ROOT.parent / "split"


# ---- build -------------------------------------------------------------------

@functools.cache
def _library(header: str, host: bool = False) -> Path:
    """``csrc/rollout.cu`` with ``header`` as ``env_body.h``, built (once
    per distinct header) by ``ppi_tpu_torch.build``. Memoized: the MPC
    loop makes a wrapper per control step and per real step, and keying
    the build re-hashes the header (1-3 MB for the hand scenes)."""
    return build_library("rollout.cu", {"env_body.h": header}, host=host)


@functools.cache
def _warp_library(header: str, host: bool = False) -> Path:
    """``csrc/rollout_warp.cu`` with ``header`` as ``env_warp.h``, built
    once per distinct header."""
    return build_library("rollout_warp.cu", {"env_warp.h": header},
                         host=host)


@functools.cache
def _split_library(header: str, host: bool = False) -> Path:
    """``csrc/rollout_split.cu`` with ``header`` as ``env_split.h``, built
    once per distinct header."""
    return build_library("rollout_split.cu", {"env_split.h": header},
                         host=host)


def load_host_rollout(header: str):
    """The host-C build of the skeleton + ``header``:
    ``fn(q0, qd0, act, dyn, consts, rew, qf, qdf, n, horizon)`` on pointers
    to C-contiguous f32 buffers in the kernel's layout (``dyn`` and
    ``consts`` may be null)."""
    return load_function(_library(header, host=True), "ppi_rollout_host",
                         8, 2, stream=False)


def load_host_warp_rollout(header: str):
    """The host-C build of the warp skeleton + ``header`` (a
    ``generate_warp_header`` text): ``load_host_rollout``'s function, each
    cooperative stage run lane by lane."""
    return load_function(_warp_library(header, host=True),
                         "ppi_rollout_warp_host", 8, 2, stream=False)


def load_host_split_rollout(header: str):
    """The host-C build of the split skeleton + ``header`` (a
    ``generate_split_header`` text): ``load_host_rollout``'s function, each
    phase run stream by stream and each stream's share lane by lane."""
    return load_function(_split_library(header, host=True),
                         "ppi_rollout_split_host", 8, 2, stream=False)


def load_host_warp_solve(header: str):
    """``fn(aug)``: the warp skeleton's cooperative Gauss-Jordan solve, as
    host C, on a C-contiguous f32 (nq, nq + 1) augmented matrix in place
    (nq is ``header``'s)."""
    return load_function(_warp_library(header, host=True),
                         "ppi_warp_solve_host", 1, 0, stream=False)


# ---- the plain version ---------------------------------------------------------

def plain_rollout(model, dt: float, substeps: int, torque_fn, reward_fn,
                  q0, qd0, actions, dyn_body=None, dyn=None, consts=None,
                  reward_takes_action: bool = False, project_fn=None):
    """What the kernel computes, eagerly over ``(N,)`` torch lanes:
    ``(q0 (N,nq), qd0 (N,nq), actions (N,H,d_a)) -> (rewards (N,H),
    qf (N,nq), qdf (N,nq))`` with the sticky NaN latch. ``consts`` (k,)
    are the reward constants; with ``reward_takes_action`` the reward gets
    the step's raw action; ``project_fn`` runs after each step's substeps
    with the step's initial coordinates."""
    m = SoaModel(model)
    if dyn_body is not None:
        m = m.with_body_offset(dyn_body, dyn.unbind(-1))
    h = dt / substeps
    q, qd = q0.unbind(-1), qd0.unbind(-1)
    c = None if consts is None else consts.unbind(-1)
    bad = torch.zeros(q0.shape[0], dtype=q0.dtype, device=q0.device)
    rewards = []
    for t in range(actions.shape[1]):
        act = actions[:, t].unbind(-1)
        tau = torque_fn(m, q, qd, act)
        q_prev = q
        for _ in range(substeps):
            q, qd = substep_soa(m, q, qd, tau, h)
        if project_fn is not None:
            q, qd = project_fn(m, q_prev, q, qd)
        fin = torch.stack([sm.isfinite(x) for x in q + qd]).amin(0)
        bad = torch.maximum(bad, 1.0 - fin)
        r = call_reward(reward_fn, m, q, qd, act, c, reward_takes_action)
        rewards.append(torch.where(bad > 0.0, torch.nan, r))
    return (torch.stack(rewards, 1), torch.stack(q, -1),
            torch.stack(qd, -1))


# ---- the wrapper -----------------------------------------------------------------

# kernel launch counters (``LAUNCHES``) of the three layouts
LAUNCH_KEYS = {"lane": "rollout", "warp": "rollout_warp",
               "split": "rollout_split"}
# each layout's launch function in its library, and the ints it takes after
# its eight pointers (N, H and the lane and warp layouts' block size)
LAUNCH_ENTRIES = {"lane": ("ppi_rollout_launch", 3),
                  "warp": ("ppi_rollout_warp_launch", 3),
                  "split": ("ppi_rollout_split_launch", 2)}
# rollouts (warps) a block of the warp layout holds
WARPS_PER_BLOCK = 1


def load_launch(lib, layout):
    """``layout``'s launch function of the built library ``lib``."""
    entry, ints = LAUNCH_ENTRIES[layout]
    return load_function(lib, entry, 8, ints, stream=True)


def stage(q0, qd0, actions, dyn=None, consts=None):
    """A launch's operands on the card: the (N, nq) lanes and (N, H, d_a)
    actions copied to the kernel's lane-major layout (the Pallas layout),
    ``dyn`` and ``consts`` as given, the (H, N) rewards and (nq, N) final
    state allocated, and the eight pointers the kernel takes; ``launch``
    may take them many times. Returns (pointers, outputs, inputs)."""
    (n, h), nq, dev = actions.shape[:2], q0.shape[1], actions.device
    ins = (q0.t().contiguous(), qd0.t().contiguous(),
           actions.permute(1, 2, 0).contiguous(), dyn, consts)
    outs = (torch.empty((h, n), dtype=torch.float32, device=dev),
            torch.empty((nq, n), dtype=torch.float32, device=dev),
            torch.empty((nq, n), dtype=torch.float32, device=dev))
    ptrs = tuple([None if x is None else x.data_ptr() for x in ins + outs])
    return ptrs, outs, ins


def launch(fn, staged, layout, size=()):
    """One launch of ``fn`` (``load_launch``'s for ``layout``) on
    ``staged`` (``stage``'s) on the current stream, ``size`` the layout's
    block size, counted in ``LAUNCHES``; returns (rewards (N, H), qpos_f
    (N, nq), qvel_f (N, nq)), views of the staged outputs."""
    ptrs, (rew, qf, qdf), _ = staged
    h, n = rew.shape
    with torch.cuda.device(rew.device):
        err = fn(*ptrs, n, h, *size, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rollout kernel ({layout} layout) launch "
                           f"failed: CUDA error {err}")
    LAUNCHES[LAUNCH_KEYS[layout]] += 1
    return rew.t(), qf.t(), qdf.t()


def make_rollout(model, dt: float, substeps: int, horizon: int,
                 action_dim: int, torque_fn, reward_fn, project_fn=None,
                 n_consts: int = 0, reward_takes_action: bool = False,
                 dyn_body=None, block: int = 128, layout: str = "lane",
                 warps: int = WARPS_PER_BLOCK, split_partition=None):
    """Build ``run(q0 (N,nq), qd0 (N,nq), actions (N,H,da), consts=None,
    dyn=None) -> (rewards (N,H), qpos_f (N,nq), qvel_f (N,nq))``, the
    counterpart of ``make_pallas_rollout``. ``layout`` "lane" launches
    ``csrc/rollout.cu`` (one rollout a thread, ``block`` threads a CUDA
    block), "warp" ``csrc/rollout_warp.cu`` (one rollout a warp,
    ``warps`` of them a block), "split" ``csrc/rollout_split.cu`` (32
    rollouts a block, each spread over its warps: list-scheduled, or with
    ``split_partition="subtree"`` partitioned by the body tree, with
    ``"chain"`` so and its heaviest chain cut into segments); all
    compute the same values bit for bit.
    ``horizon`` is only checked: the kernel takes it at run time, so one
    build serves every H. With ``n_consts`` the run takes the (n_consts,)
    f32 reward constants ``consts`` on the actions' device;
    ``project_fn(m, q_prev, q, qd)`` is the per-step projection.
    ``run.load()`` builds and loads the kernel (the first CUDA launch does
    it otherwise). On the card ``run`` is ``run.launch(run.stage(...))``:
    ``run.stage`` takes ``run``'s arguments, checks them and lays them out
    (``stage``), and ``run.launch`` launches the kernel on what it staged,
    as often as it is called."""
    if layout not in LAUNCH_KEYS:
        raise ValueError(f"layout must be one of {sorted(LAUNCH_KEYS)}, "
                         f"not {layout!r}")
    nq = model.nq
    fn = None
    size = {"lane": (block,), "warp": (warps,), "split": ()}[layout]
    args = (model, dt, substeps, action_dim, torque_fn, reward_fn, dyn_body,
            n_consts, reward_takes_action, project_fn)

    def load():
        if layout == "warp":
            lib = _warp_library(_warp_header(*args))
        elif layout == "split":
            lib = _split_library(_split_header(*args, split_partition))
        else:
            lib = _library(_env_header(*args))
        return load_launch(lib, layout)

    def checked_consts(consts, dev):
        if not n_consts:
            return None
        if consts is None or consts.shape != (n_consts,) \
                or consts.device != dev or consts.dtype != torch.float32:
            raise ValueError(f"consts must be a ({n_consts},) float32 "
                             f"tensor on {dev}")
        return consts.contiguous()

    def run_stage(q0, qd0, actions, consts=None, dyn=None):
        dev = actions.device
        consts = checked_consts(consts, dev)
        if dev.type != "cuda":
            raise TypeError(f"no rollout kernel for {dev}")
        n = actions.shape[0]
        for name, x in (("q0", q0), ("qd0", qd0), ("actions", actions)):
            if x.device != dev or x.dtype != torch.float32:
                raise TypeError(f"{name}: expected float32 on {dev}, got "
                                f"{x.dtype} on {x.device}")
        if q0.shape != (n, nq) or qd0.shape != (n, nq) or \
                actions.shape != (n, horizon, action_dim):
            raise ValueError(
                f"shapes q0 {tuple(q0.shape)}, qd0 {tuple(qd0.shape)}, "
                f"actions {tuple(actions.shape)}; expected ({n}, {nq}) and "
                f"({n}, {horizon}, {action_dim})")
        if n == 0:
            raise ValueError("empty batch")
        if dyn_body is None:
            dyn = None
        elif dyn is None or dyn.shape != (3,) or dyn.device != dev \
                or dyn.dtype != torch.float32:
            raise ValueError("dyn must be a (3,) float32 tensor on "
                             f"{dev} for a scene with a dynamic body")
        else:
            dyn = dyn.contiguous()
        return stage(q0, qd0, actions, dyn, consts)

    def run_launch(staged):
        nonlocal fn
        if fn is None:
            fn = load()
        return launch(fn, staged, layout, size)

    def run(q0, qd0, actions, consts=None, dyn=None):
        if actions.device.type == "cpu":
            return plain_rollout(model, dt, substeps, torque_fn, reward_fn,
                                 q0, qd0, actions, dyn_body, dyn,
                                 checked_consts(consts, actions.device),
                                 reward_takes_action, project_fn)
        return run_launch(run_stage(q0, qd0, actions, consts, dyn))

    run.layout = layout
    run.load = load
    run.stage = run_stage
    run.launch = run_launch
    return run


def supports_kernel(env) -> bool:
    """True when ``env`` implements the scalar kernel contract."""
    return (hasattr(env, "scalar_torque") and hasattr(env, "scalar_reward")
            and hasattr(env, "_model"))


def kernel_operands(env, state0):
    """(consts, dyn_body, dyn): the per-episode kernel inputs of
    ``state0`` (``_pallas_operands`` of the JAX package)."""
    consts = None
    if hasattr(env, "scalar_reward_consts"):
        consts = env.scalar_reward_consts(state0)
    dyn_body = getattr(env, "scalar_dyn_body", None)
    dyn = env.scalar_dyn_consts(state0) if dyn_body is not None else None
    return consts, dyn_body, dyn


def body_args(env, state):
    """The positional arguments of ``generate_env_header``,
    ``generate_warp_header``, ``generate_split_header`` and
    ``ops_per_lane_step`` for ``env``;
    ``state`` gives the number of reward constants. ``env_rollout`` adds
    the env's layout (``kernel_layout``)."""
    consts, dyn_body, _ = kernel_operands(env, state)
    return (env._model, env.dt, env.substeps, env.action_dim,
            env.scalar_torque, env.scalar_reward, dyn_body,
            0 if consts is None else consts.shape[0],
            getattr(env, "scalar_reward_takes_action", False),
            getattr(env, "scalar_project", None))


def kernel_layout(env) -> str:
    """The rollout kernel's layout for ``env``: its
    ``scalar_kernel_layout`` ("warp" for the bodies too large for one
    thread, "split" where spreading one rollout's program over a block's
    warps beat the lane layout), else "lane"."""
    return getattr(env, "scalar_kernel_layout", "lane")


def split_partition(env):
    """How ``env``'s split body is planned: its ``scalar_split_partition``
    ("subtree": partitioned by the body tree, ``split_layout.
    plan_partition``; "chain": so, with the heaviest chain of bodies cut
    into segments), else None (list-scheduled)."""
    return getattr(env, "scalar_split_partition", None)


def launch_key(env) -> str:
    """The ``LAUNCHES`` counter that ``env``'s rollout launches add to."""
    return LAUNCH_KEYS[kernel_layout(env)]


def env_rollout(env, state, horizon: int, block: int = 128, layout=None):
    """``make_rollout`` with ``env``'s kernel options and layout (or
    ``layout``)."""
    model, dt, substeps, action_dim, torque_fn, reward_fn, dyn_body, \
        n_consts, takes_action, project_fn = body_args(env, state)
    return make_rollout(model, dt, substeps, horizon, action_dim, torque_fn,
                        reward_fn, project_fn=project_fn, n_consts=n_consts,
                        reward_takes_action=takes_action, dyn_body=dyn_body,
                        block=block, layout=layout or kernel_layout(env),
                        split_partition=split_partition(env))


def env_plain_rollout(env, state, q0, qd0, actions):
    """``plain_rollout`` with ``env``'s kernel options and ``state``'s
    per-episode inputs: the kernel's plain version for any env, on any
    device."""
    consts, dyn_body, dyn = kernel_operands(env, state)
    return plain_rollout(env._model, env.dt, env.substeps, env.scalar_torque,
                         env.scalar_reward, q0, qd0, actions, dyn_body, dyn,
                         consts,
                         getattr(env, "scalar_reward_takes_action", False),
                         getattr(env, "scalar_project", None))


def kernel_step(env, state, action):
    """One control step of ``env`` as one launch of its rollout kernel:
    a lane per state of the batch, H=1, the state's per-episode inputs.
    ``(state (..., nq), action (..., d_a)) -> (qpos, qvel, reward (...))``.
    The same build as the objective's; on a CPU state it runs the plain
    version. A lane whose state goes non-finite gets a NaN reward (the
    kernel's latch)."""
    consts, _, dyn = kernel_operands(env, state)
    qpos, qvel = state.physics.qpos, state.physics.qvel
    nq = qpos.shape[-1]
    run = env_rollout(env, state, 1)
    rew, qf, qdf = run(qpos.reshape(-1, nq), qvel.reshape(-1, nq),
                       action.reshape(-1, 1, env.action_dim), consts=consts,
                       dyn=dyn)
    return (qf.reshape(qpos.shape), qdf.reshape(qvel.shape),
            rew.reshape(qpos.shape[:-1]))


def plain_step(env, state, action):
    """One control step of ``env``'s scalar program, eagerly, over whatever
    batch shape the state has: torque, the substeps, the projection (for an
    env that has one), the reward. ``(state (..., nq), action (..., d_a))
    -> (qpos, qvel, reward (...))``."""
    consts, dyn_body, dyn = kernel_operands(env, state)
    m = env._soa
    if dyn_body is not None:
        m = m.with_body_offset(dyn_body, dyn.unbind(-1))
    q = state.physics.qpos.unbind(-1)
    qd = state.physics.qvel.unbind(-1)
    act = action.unbind(-1)
    tau = env.scalar_torque(m, q, qd, act)
    q_prev, h = q, env.dt / env.substeps
    for _ in range(env.substeps):
        q, qd = substep_soa(m, q, qd, tau, h)
    project = getattr(env, "scalar_project", None)
    if project is not None:
        q, qd = project(m, q_prev, q, qd)
    reward = call_reward(
        env.scalar_reward, m, q, qd, act,
        None if consts is None else consts.unbind(-1),
        getattr(env, "scalar_reward_takes_action", False))
    return torch.stack(q, -1), torch.stack(qd, -1), reward


def env_step(env, state, action, plain: bool = False):
    """``env.step`` for an env whose real step runs through its rollout
    kernel: one launch (``kernel_step``) on a CUDA state, ``plain_step`` on
    a CPU state or when ``plain`` is set. Returns (next state, reward)."""
    step = plain_step if plain or state.physics.qpos.device.type == "cpu" \
        else kernel_step
    qpos, qvel, reward = step(env, state, action)
    return dataclasses.replace(
        state, physics=dataclasses.replace(state.physics, qpos=qpos,
                                           qvel=qvel),
        t=state.t + 1), reward


def kernel_mpc_objective(env, state0, horizon: int, horizon_mask=None,
                         block: int = 128, risk_quantile: float = 1.0,
                         risk_weight: float = 0.0):
    """Counterpart of ``pallas_mpc_objective``: ``f(generator, actions
    (N,H,da)) -> costs (N,)`` with the whole rollout in one kernel launch.
    The kernel returns the (N, H) rewards, which ``risk_aggregate`` reduces
    as the eager objective does (at ``risk_weight`` 0, ``-sum``)."""
    if not supports_kernel(env):
        raise ValueError(f"{env!r} does not implement the scalar kernel "
                         "contract (scalar_torque/scalar_reward)")
    consts, _, dyn = kernel_operands(env, state0)
    run = env_rollout(env, state0, horizon, block)
    q0, qd0 = state0.physics.qpos, state0.physics.qvel

    def f(generator, action_sequences):
        del generator
        n = action_sequences.shape[0]
        rewards, _, _ = run(q0.expand(n, -1), qd0.expand(n, -1),
                            action_sequences, consts=consts, dyn=dyn)
        return risk_aggregate(rewards, horizon_mask, risk_quantile,
                              risk_weight)

    return f


def sharded_kernel_mpc_objective(env, state0, horizon: int, mesh,
                                 horizon_mask=None, block: int = 128,
                                 axis="samples", risk_quantile: float = 1.0,
                                 risk_weight: float = 0.0):
    """Counterpart of ``sharded_pallas_mpc_objective``: every rank holds
    the same (N, H, da) actions and launches the rollout kernel once on its
    shard of the sample axis (``parallel.mesh.shard_bounds``: N/W lanes),
    reduces the shard's rewards with ``risk_aggregate`` and gathers the
    full (N,) costs (``parallel.mesh.gather_costs``). The kernel's lanes
    are independent, so the costs equal ``kernel_mpc_objective``'s bit for
    bit. On CPU tensors each shard runs the plain rollout. N must divide
    evenly over the axis."""
    if not supports_kernel(env):
        raise ValueError(f"{env!r} does not implement the scalar kernel "
                         "contract (scalar_torque/scalar_reward)")
    consts, _, dyn = kernel_operands(env, state0)
    run = env_rollout(env, state0, horizon, block)
    q0, qd0 = state0.physics.qpos, state0.physics.qvel

    def f(generator, action_sequences):
        del generator
        n = action_sequences.shape[0]
        lo, hi = shard_bounds(n, mesh, axis)
        rewards, _, _ = run(q0.expand(hi - lo, -1), qd0.expand(hi - lo, -1),
                            action_sequences[lo:hi], consts=consts, dyn=dyn)
        return gather_costs(risk_aggregate(rewards, horizon_mask,
                                           risk_quantile, risk_weight),
                            n, mesh, axis)

    return f
