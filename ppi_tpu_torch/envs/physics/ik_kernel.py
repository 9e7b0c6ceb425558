"""The scripted experts' palm-IK kernel: generator, build, wrapper, plain
version.

The JAX package's scripted experts solve the palm's inverse kinematics by
projected gradient descent, a Python loop over ``jax.jit(jax.grad(obj))``
with ``obj`` the squared distance of the palm geom (``env._sites_soa``) to
a target, plus ``w (x1 + x2 + x3)^2`` where the palm is kept level
(``ppi_tpu/envs/door_hand.py:344-361``, ``door_adroit.py:351-371``,
``hammer_hand.py:367-386``, ``hammer_adroit.py:390-409``,
``relocate_adroit.py:360-379``). It has no Pallas kernel. Eagerly, one
iteration is the whole-site FK and its backward, 2.5k-8.7k torch launches,
and an expert runs 1,000-42,000 iterations, so the port gives the loop a
kernel written by hand for Hopper: ``csrc/ik_palm.cu``, one thread running
every iteration of one IK call in one launch.

Its body (``ik_body.h``) is generated here from the scalar program
(``generate_ik_header``): ``ppi_ik_grad`` runs ``engine_soa.fk_soa`` and
``geom_point_soa`` over symbols for the palm point p and writes the
gradient from the palm's geometric Jacobian, ``2 (a_j x (p - o_j)) . (p -
t)`` for a hinge j among the palm body's ancestors and ``2 a_j . (p - t)``
for a slide, with ``a_j`` and ``o_j`` the joint's world axis and origin
from the same FK (``make_body_frames_soa``'s frames). Every other
variable (a digit) gets what autograd's chain rule gives it, a zero
cotangent times its own body's Jacobian column: exactly 0 while the FK is
finite, NaN once it is not (as in JAX, a NaN target turns the arm NaN at
the first step and the digits at the second: no partial result). With
``level`` it adds ``w (2 s)``, ``s = x1 + x2 + x3``, to x1-x3. A scene offset (the door frame, the board) is a runtime
input of the FK, as in the rollout kernel. Built with ``nvcc`` for
``sm_90a`` and ``-fmad=false`` (every operation rounded once, as the plain
version's eager ops) at first use into ``build/kernels/<hash>/``, bound
with ``ctypes`` (``ppi_tpu_torch/build.py``); the file also compiles as
host C, which the CPU tests run against the plain version.

``palm_ik`` routes: a CPU tensor takes the plain version
(``plain_palm_ik``, the direct port: ``torch.autograd.grad`` through
``env._sites_soa``, the same ``lr``, ``iters`` and clip of every entry),
a CUDA tensor one launch of the kernel, counted in
``LAUNCHES[LAUNCH_KEY]``; a build or launch that fails raises.
"""

import functools
import re

import torch

from ppi_tpu_torch.build import LAUNCHES, build_library, load_function
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, fk_soa, geom_point_soa, jacobian_column, v3_dot, v3_sub)

LAUNCH_KEY = "ik_palm"
SOURCE, HEADER = "ik_palm.cu", "ik_body.h"
# f32 operations of a step besides the gradient, per variable: lr * g, the
# subtraction and the clip's max and min
STEP_OPS = 4


# ---- code generation --------------------------------------------------------

def generate_ik_header(model, palm_geom: int, n_var: int, dyn_body=None,
                       level: bool = False) -> str:
    """C source of the kernel's body (``ik_body.h``): the gradient of the
    palm geom ``palm_geom``'s squared distance to the target over the
    first ``n_var`` coordinates of ``model``, the scene offset of
    ``dyn_body`` (if any) a runtime input, and with ``level`` the level
    penalty's term. Deterministic: the same inputs give the same text,
    which keys the build."""
    return _generate(model, palm_geom, n_var, dyn_body, level)[0]


def ops_per_iteration(model, palm_geom: int, n_var: int, dyn_body=None,
                      level: bool = False) -> int:
    """f32 operations of one iteration: those of the emitted gradient that
    its outputs read (the compiler drops the bodies the palm does not
    depend on), plus ``STEP_OPS`` a variable. Times ``iters``, the work
    of a launch."""
    return _generate(model, palm_geom, n_var, dyn_body, level)[1]


def chain_per_iteration(model, palm_geom: int, n_var: int, dyn_body=None,
                        level: bool = False) -> int:
    """The longest chain of dependent f32 operations in one iteration (a
    math call counted as one): the gradient's deepest output, then the
    step's multiply, subtraction, max and min. One thread runs it
    ``iters`` times in a row, which bounds the launch from below."""
    return _generate(model, palm_geom, n_var, dyn_body, level)[2]


_LINE = re.compile(r"  const float (\w+) = (.*);")
_NAME = re.compile(r"\b(t\d+)\b")


def _chain_and_ops(lines, outputs):
    """(the longest chain of dependent operations to any of ``outputs``,
    the operations they read directly or not): what is left of the
    emitted lines once the compiler drops those no output reads."""
    depth, reads = {}, {}
    for text in lines:
        name, expr = _LINE.fullmatch(text).groups()
        if not name.startswith("t"):
            continue
        reads[name] = _NAME.findall(expr)
        depth[name] = (0 if sm._LITERAL.fullmatch(expr) else 1) + max(
            (depth[n] for n in reads[name]), default=0)
    live, todo = set(), list(outputs)
    while todo:
        name = todo.pop()
        if name not in live:
            live.add(name)
            todo.extend(reads[name])
    ops = sum(1 for text in lines if _LINE.fullmatch(text).group(1) in live
              and not sm._LITERAL.fullmatch(_LINE.fullmatch(text).group(2)))
    return max((depth[n] for n in outputs), default=0), ops


@functools.cache
def _generate(model, palm_geom, n_var, dyn_body, level):
    m = SoaModel(model)
    if not 0 < n_var < m.nq:
        raise ValueError(f"{n_var} IK variables of {m.nq} coordinates")
    em = sm.Emitter()
    q = tuple(em.input(f"q_{j}", f"q[{j}]") for j in range(m.nq))
    target = tuple(em.input(f"target_{c}", f"target[{c}]") for c in range(3))
    if dyn_body is not None:
        m = m.with_body_offset(dyn_body, tuple(
            em.input(f"dyn_{c}", f"dyn[{c}]") for c in range(3)))
    rots, poss, axes, coms = fk_soa(m, q)
    p = geom_point_soa(m, rots, poss, palm_geom)
    err = v3_sub(p, target)
    ancestors = m.ancestors[m.sphere_body[palm_geom]]
    grad = []
    for j in range(n_var):
        if j in ancestors:
            col = jacobian_column(m, j, axes[j], poss[j], p)[0]
            grad.append(2.0 * v3_dot(col, err))
        else:
            # the zero cotangent through the joint's own column: 0, or NaN
            # where the FK down to its body is not finite
            col = jacobian_column(m, j, axes[j], poss[j], coms[j])[0]
            grad.append(0.0 * (col[0] + col[1] + col[2]))
    if level:
        if n_var < 4:
            raise ValueError("the level penalty reads x1-x3")
        w = em.input("w", "params[1]")
        s = q[1] + q[2] + q[3]
        for j in (1, 2, 3):
            grad[j] = grad[j] + w * (2.0 * s)
    out = [(f"g[{j}]", v) for j, v in enumerate(grad)]
    chain, ops = _chain_and_ops(
        em.lines, [v.name for v in grad if isinstance(v, sm.Sym)])
    body = sm.c_function(
        "void ppi_ik_grad(const float* q, const float* target, "
        "const float* dyn, const float* params, float* g)", em, out)
    defines = [f"#define PPI_IK_NQ {m.nq}", f"#define PPI_IK_NV {n_var}"]
    if dyn_body is not None:
        defines.append("#define PPI_IK_DYN 1")
    if level:
        defines.append("#define PPI_IK_LEVEL 1")
    text = "\n".join([
        "/* Body of ppi_tpu_torch/csrc/ik_palm.cu, generated by",
        "   ppi_tpu_torch/envs/physics/ik_kernel.py from the scalar program",
        f"   (palm geom {palm_geom}, {n_var} of {m.nq} coordinates"
        f"{', level penalty' if level else ''}). Do not edit. */",
        *defines, "", sm.C_HELPERS, body])
    return text, ops + STEP_OPS * n_var, chain + STEP_OPS


def env_header(env, n_var: int, level: bool = False) -> str:
    """``generate_ik_header`` for ``env``'s palm geom and scene offset."""
    return _env_header(env, n_var, level)


@functools.cache
def _env_header(env, n_var, level):
    return generate_ik_header(env._model, env._palm_geom, n_var,
                              getattr(env, "scalar_dyn_body", None), level)


# ---- build ------------------------------------------------------------------

@functools.cache
def _library(header: str, host: bool = False):
    return build_library(SOURCE, {HEADER: header}, host=host)


def load_host_ik(header: str):
    """The host-C build of the skeleton + ``header``: ``fn(x0, q_fixed,
    target, dyn, lo, hi, params, out, iters)`` on pointers to C-contiguous
    f32 buffers (``dyn`` may be null where the header reads none)."""
    return load_function(_library(header, host=True), "ppi_ik_host", 8, 1,
                         stream=False)


def load_host_grad(header: str):
    """The host-C build's gradient alone: ``fn(q, target, dyn, params,
    g)``, ``q`` the whole configuration (nq,), ``params`` (lr, w), ``g``
    (n,) written."""
    return load_function(_library(header, host=True), "ppi_ik_grad_host", 5,
                         0, stream=False)


def load_launch(header: str):
    """The launch of the kernel built with ``header``: ``fn(x0, q_fixed,
    target, dyn, lo, hi, params, out, iters, stream)``."""
    return load_function(_library(header), "ppi_ik_launch", 8, 1,
                         stream=True)


# ---- the plain version ------------------------------------------------------

def plain_palm_ik(env, x0, q_rest, target, lo, hi, iters: int, lr: float,
                  level_weight=None, dyn=None):
    """What the kernel computes, eagerly: ``iters`` steps of ``x <-
    clip(x - lr grad f(x), lo, hi)`` from ``x0`` (n,), with ``f(x) =
    |palm(cat(x, q_rest)) - target|^2 [+ level_weight (x1 + x2 +
    x3)^2]``, the palm from ``env._sites_soa`` (through the scene offset
    ``dyn``) and the gradient from ``torch.autograd``. Every entry of x is
    clipped each step."""
    palm = env._palm_geom

    def objective(x):
        pts = env._sites_soa(torch.cat([x, q_rest]), dyn)
        f = ((pts[palm] - target) ** 2).sum()
        if level_weight is not None:
            f = f + level_weight * (x[1] + x[2] + x[3]) ** 2
        return f

    x = x0.detach()
    for _ in range(iters):
        var = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(objective(var), var)
        x = torch.minimum(torch.maximum(x - lr * g, lo), hi)
    return x


# ---- the wrapper ------------------------------------------------------------

def palm_ik(env, x0, q_rest, target, lo, hi, iters: int, lr: float,
            level_weight=None, dyn=None):
    """The palm IK of ``plain_palm_ik``: on CPU tensors the plain version,
    on CUDA tensors one launch of ``csrc/ik_palm.cu`` with ``env``'s
    generated body (built at first use). Returns x (n,)."""
    dev = x0.device
    if dev.type == "cpu":
        return plain_palm_ik(env, x0, q_rest, target, lo, hi, iters, lr,
                             level_weight, dyn)
    if dev.type != "cuda":
        raise TypeError(f"no palm-IK kernel for {dev}")
    n = x0.shape[0]
    nq = env._model.nq
    dyn_body = getattr(env, "scalar_dyn_body", None)
    shapes = {"x0": (x0, (n,)), "q_rest": (q_rest, (nq - n,)),
              "target": (target, (3,)), "lo": (lo, (n,)), "hi": (hi, (n,))}
    if dyn_body is not None:
        shapes["dyn"] = (dyn, (3,))
    for name, (x, shape) in shapes.items():
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != shape:
            raise TypeError(f"{name}: expected float32 {shape} on {dev}, got "
                            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")
    fn = load_launch(env_header(env, n, level_weight is not None))
    q_fixed = torch.cat([x0, q_rest]).contiguous()
    params = torch.tensor(
        [lr, 0.0 if level_weight is None else level_weight],
        dtype=torch.float32).to(dev)
    ins = [x0.contiguous(), q_fixed, target.contiguous(),
           None if dyn_body is None else dyn.contiguous(), lo.contiguous(),
           hi.contiguous(), params]
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(*[None if x is None else x.data_ptr() for x in ins],
                 out.data_ptr(), iters,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"palm-IK kernel launch failed: CUDA error {err}")
    LAUNCHES[LAUNCH_KEY] += 1
    return out
