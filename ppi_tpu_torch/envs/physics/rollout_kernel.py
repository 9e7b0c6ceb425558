"""The whole-rollout CUDA kernel: generator, build, wrapper, plain version.

Counterpart of ``ppi_tpu/envs/physics/pallas_rollout.py``. The JAX package
traces the env's scalar program into a Pallas body; here the same program
runs over ``scalar_math.Sym`` and emits the per-env body of a hand-written
CUDA skeleton (``ppi_tpu_torch/csrc/rollout.cu``):

  * ``env_torque``  -- the env's ``scalar_torque``;
  * ``env_substep`` -- one ``engine_soa.substep_soa``;
  * ``env_reward``  -- the env's ``scalar_reward``.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/<hash of sources and flags>/`` and bound with ``ctypes``
(``ppi_tpu_torch/build.py``).

The wrapper returned by ``make_rollout`` takes the plain version (the same
scalar program, eagerly over torch tensors) for CPU tensors only. For CUDA
tensors it launches the kernel or raises; ``LAUNCHES["rollout"]`` (the
shared counter of ``ppi_tpu_torch.build``) counts the launches.

Env contract (duck-typed, as ``ppi_tpu``'s): ``env._model``, ``env.dt``,
``env.substeps``, ``env.action_dim``, ``env.scalar_torque(m, q, qd, act)``,
``env.scalar_reward(m, q, qd)``, and optionally ``env.scalar_dyn_body``
with ``env.scalar_dyn_consts(state) -> (3,)``. Reward constants, rewards
that take the action and per-step projections are not ported yet.
"""

import functools
from pathlib import Path

import torch

from ppi_tpu_torch.build import LAUNCHES, build_library, load_function
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel, substep_soa

# ---- code generation -------------------------------------------------------

def _function(signature: str, em: sm.Emitter, outputs) -> str:
    body = "\n".join(em.lines + [f"  {lhs} = {sm._operand(v)};"
                                 for lhs, v in outputs])
    return f"PPI_QUAL {signature} {{\n{body}\n}}\n"


def generate_env_header(model, dt: float, substeps: int, action_dim: int,
                        torque_fn, reward_fn, dyn_body=None) -> str:
    """C source of the per-env body (``env_body.h``) for the skeleton.

    Runs the scalar program over symbols; every model constant is folded
    and written as an exact f32 literal, and the sampled body offset (when
    ``dyn_body`` is set) is read from ``dyn[0..2]``. Deterministic: the
    same inputs give the same text, which keys the build cache."""
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
    torque = _function(
        "void env_torque(const float* q, const float* qd, const float* act, "
        "const float* dyn, float* tau)",
        em, [(f"tau[{j}]", tau[j]) for j in range(nq)])

    em = sm.Emitter()
    mm, q, qd, tau = prologue(em, with_tau=True)
    q2, qd2 = substep_soa(mm, q, qd, tau, h)
    substep = _function(
        "void env_substep(float* q, float* qd, const float* tau, "
        "const float* dyn)",
        em, [(f"q[{j}]", q2[j]) for j in range(nq)]
        + [(f"qd[{j}]", qd2[j]) for j in range(nq)])

    em = sm.Emitter()
    mm, q, qd, _ = prologue(em)
    r = reward_fn(mm, q, qd)
    em.lines.append(f"  return {sm._operand(r)};")
    reward = _function(
        "float env_reward(const float* q, const float* qd, const float* dyn)",
        em, [])

    return "\n".join([
        "/* Per-env body of ppi_tpu_torch/csrc/rollout.cu, generated by",
        "   ppi_tpu_torch/envs/physics/rollout_kernel.py from the scalar",
        "   physics program. Do not edit. */",
        f"#define PPI_NQ {nq}",
        f"#define PPI_DA {action_dim}",
        f"#define PPI_SUBSTEPS {substeps}",
        "",
        sm.C_HELPERS,
        torque, substep, reward])


# the MPC agent builds an objective per control step: generate each env's
# body once (model and bound methods hash by identity and value)
_env_header = functools.lru_cache(maxsize=8)(generate_env_header)


# ---- build -------------------------------------------------------------------

def _library(header: str, host: bool = False) -> Path:
    """``csrc/rollout.cu`` with ``header`` as ``env_body.h``, built (once
    per distinct header) by ``ppi_tpu_torch.build``."""
    return build_library("rollout.cu", {"env_body.h": header}, host=host)


def load_host_rollout(header: str):
    """The host-C build of the skeleton + ``header``:
    ``fn(q0, qd0, act, dyn, rew, qf, qdf, n, horizon)`` on pointers to
    C-contiguous f32 buffers in the kernel's layout."""
    return load_function(_library(header, host=True), "ppi_rollout_host",
                         7, 2, stream=False)


# ---- the plain version ---------------------------------------------------------

def plain_rollout(model, dt: float, substeps: int, torque_fn, reward_fn,
                  q0, qd0, actions, dyn_body=None, dyn=None):
    """What the kernel computes, eagerly over ``(N,)`` torch lanes:
    ``(q0 (N,nq), qd0 (N,nq), actions (N,H,d_a)) -> (rewards (N,H),
    qf (N,nq), qdf (N,nq))`` with the sticky NaN latch."""
    m = SoaModel(model)
    if dyn_body is not None:
        m = m.with_body_offset(dyn_body, dyn.unbind(-1))
    h = dt / substeps
    q, qd = q0.unbind(-1), qd0.unbind(-1)
    bad = torch.zeros(q0.shape[0], dtype=q0.dtype, device=q0.device)
    rewards = []
    for t in range(actions.shape[1]):
        tau = torque_fn(m, q, qd, actions[:, t].unbind(-1))
        for _ in range(substeps):
            q, qd = substep_soa(m, q, qd, tau, h)
        fin = torch.stack([sm.isfinite(x) for x in q + qd]).amin(0)
        bad = torch.maximum(bad, 1.0 - fin)
        r = reward_fn(m, q, qd)
        rewards.append(torch.where(bad > 0.0, torch.nan, r))
    return (torch.stack(rewards, 1), torch.stack(q, -1),
            torch.stack(qd, -1))


# ---- the wrapper -----------------------------------------------------------------

def make_rollout(model, dt: float, substeps: int, horizon: int,
                 action_dim: int, torque_fn, reward_fn, project_fn=None,
                 n_consts: int = 0, reward_takes_action: bool = False,
                 dyn_body=None, block: int = 128):
    """Build ``run(q0 (N,nq), qd0 (N,nq), actions (N,H,da), consts=None,
    dyn=None) -> (rewards (N,H), qpos_f (N,nq), qvel_f (N,nq))``, the
    counterpart of ``make_pallas_rollout``. ``block`` is the number of
    threads (lanes) per CUDA block. ``horizon`` is only checked: the kernel
    takes it at run time, so one build serves every H."""
    if project_fn is not None or n_consts or reward_takes_action:
        raise NotImplementedError(
            "reward constants, action-dependent rewards and per-step "
            "projections are ROADMAP queue 2 item 1b/1c")
    nq = model.nq
    fn = None

    def launch(q0, qd0, actions, dyn):
        nonlocal fn
        dev = actions.device
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
        dyn_ptr = None
        if dyn_body is not None:
            if dyn is None or dyn.shape != (3,) or dyn.device != dev \
                    or dyn.dtype != torch.float32:
                raise ValueError("dyn must be a (3,) float32 tensor on "
                                 f"{dev} for a scene with a dynamic body")
            dyn = dyn.contiguous()
            dyn_ptr = dyn.data_ptr()
        if fn is None:
            fn = load_function(_library(_env_header(
                model, dt, substeps, action_dim, torque_fn, reward_fn,
                dyn_body)), "ppi_rollout_launch", 7, 3, stream=True)
        # the kernel's lane-major layout (the Pallas layout)
        q0_t = q0.t().contiguous()
        qd0_t = qd0.t().contiguous()
        act_t = actions.permute(1, 2, 0).contiguous()
        rew = torch.empty((horizon, n), dtype=torch.float32, device=dev)
        qf = torch.empty((nq, n), dtype=torch.float32, device=dev)
        qdf = torch.empty((nq, n), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(q0_t.data_ptr(), qd0_t.data_ptr(), act_t.data_ptr(),
                     dyn_ptr, rew.data_ptr(), qf.data_ptr(), qdf.data_ptr(),
                     n, horizon, block, stream)
        if err != 0:
            raise RuntimeError(f"rollout kernel launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["rollout"] += 1
        return rew.t(), qf.t(), qdf.t()

    def run(q0, qd0, actions, consts=None, dyn=None):
        del consts
        if actions.device.type == "cpu":
            return plain_rollout(model, dt, substeps, torque_fn, reward_fn,
                                 q0, qd0, actions, dyn_body, dyn)
        if actions.device.type != "cuda":
            raise TypeError(f"no rollout kernel for {actions.device}")
        return launch(q0, qd0, actions, dyn)

    return run


def supports_kernel(env) -> bool:
    """True when ``env`` implements the scalar kernel contract."""
    return (hasattr(env, "scalar_torque") and hasattr(env, "scalar_reward")
            and hasattr(env, "_model"))


def kernel_mpc_objective(env, state0, horizon: int, horizon_mask=None,
                         block: int = 128):
    """Counterpart of ``pallas_mpc_objective``: ``f(generator, actions
    (N,H,da)) -> costs (N,)`` with the whole rollout in one kernel launch."""
    if not supports_kernel(env):
        raise ValueError(f"{env!r} does not implement the scalar kernel "
                         "contract (scalar_torque/scalar_reward)")
    dyn_body = getattr(env, "scalar_dyn_body", None)
    dyn = env.scalar_dyn_consts(state0) if dyn_body is not None else None
    run = make_rollout(env._model, env.dt, env.substeps, horizon,
                       env.action_dim, env.scalar_torque, env.scalar_reward,
                       dyn_body=dyn_body, block=block)
    q0, qd0 = state0.physics.qpos, state0.physics.qvel

    def f(generator, action_sequences):
        del generator
        n = action_sequences.shape[0]
        rewards, _, _ = run(q0.expand(n, -1), qd0.expand(n, -1),
                            action_sequences, dyn=dyn)
        if horizon_mask is not None:
            rewards = rewards * horizon_mask[None, :]
        return -torch.sum(rewards, dim=1)

    return f

