"""The ball-in-a-cup kernel: generator, build, wrapper, plain version.

The JAX package evaluates a batch of ball-in-a-cup trajectories as an XLA
scan under ``jax.vmap`` (``ppi_tpu/envs/episodic.py``, ``BallInACup.
evaluate``, over ``BallInCupSim.execute_trajectory`` at
``ppi_tpu/envs/ball_in_a_cup.py:341-372``); it has no Pallas kernel. Run
eagerly, one trajectory of 1,600 steps is some 30 million torch launches,
so the port gives it a kernel written by hand for Hopper, in two layouts
of one program, bit for bit the same.

The one-thread layout, ``csrc/bic_rollout.cu`` (one thread a trajectory,
all three phases in one launch, the lane's state in registers), runs a
body generated here from the scalar program of ``envs/ball_in_a_cup.py``
(``generate_bic_header``):

  * ``bic_reset``  -- ``reset_soa``: the arm at rest, the string hanging;
  * ``bic_arm``    -- ``arm_soa``: PD torque + ``J^T F``, forward dynamics;
  * ``bic_string`` -- ``string_soa``: the PBD pass and the reaction;
  * ``bic_commit`` -- ``commit_soa``: the new state and its statistics;
  * ``bic_score``  -- ``score_soa``: the reward and the success flag.

The skeleton composes them as ``BallInCupSim.step_soa`` does, the
predictor-corrector pass with ``PPI_BIC_SAME_STEP``; the body is
generated for one ``BallInCupSim`` (its string resolution, sweeps and
coupling). Every particle loop is unrolled by the generator, so no array
is indexed at run time.

The warp layout, ``csrc/bic_rollout_warp.cu`` (one warp a trajectory, a
point of the string and its Jacobi segment a lane, the sweeps a loop with
two exchanges each), runs a body of per-point, per-segment and lane-0
functions generated from the same program's helpers
(``generate_warp_header``); it is the route (``route``) wherever the
string's points fit a warp.

Both are built with ``nvcc`` for ``sm_90a`` (``-fmad=false``, as the
rollout bodies: each operation rounded once, as its plain version's eager
ops) at first use into ``build/kernels/<hash>/``, bound with ``ctypes``
(``ppi_tpu_torch/build.py``). Both files also compile as host C, which the
CPU tests run against the plain version and against each other.

The wrapper of ``make_bic_rollout`` takes the plain version
(``BallInCupSim.execute_trajectory`` and ``reward_and_success``, eagerly
over torch tensors) for CPU tensors only; on a CUDA tensor it launches the
kernel in its layout or raises. ``LAUNCHES[LAUNCH_KEYS[layout]]`` counts
the launches of each layout.
"""

import functools
import re

import torch

from ppi_tpu_torch.build import LAUNCHES, build_library, load_function
from ppi_tpu_torch.envs import ball_in_a_cup as bic
from ppi_tpu_torch.envs.physics import scalar_math as sm

# each layout's launch counter
LAUNCH_KEYS = {"thread": "bic_rollout", "warp": "bic_rollout_warp"}
# the one-thread layout's trajectories (threads) a block: 128 trajectories
# are then 4 blocks on 4 SMs
BLOCK = 32
# the warp layout's trajectories (warps) a block: 1, 2 and 4 within 2% of
# each other at N=128 and N=1000, 2 the least at both (PERF.md section 6)
WARPS = 2


# ---- code generation --------------------------------------------------------

def _emit(signature, inputs, body, outputs):
    """One generated function: ``inputs`` maps each C array argument to its
    length (bound to locals once), ``body(*arrays)`` runs the program on
    them and returns the values ``outputs`` (an array name) takes, in
    order; an output that is None is not written. Returns (text, ops)."""
    em = sm.Emitter()
    arrays = [tuple(em.input(f"{name}_{k}", f"{name}[{k}]")
                    for k in range(size)) for name, size in inputs]
    values = body(*arrays)
    out = [(f"{outputs}[{k}]", v) for k, v in enumerate(values)
           if v is not None]
    return sm.c_function(signature, em, out), em.ops


_DIVISION = re.compile(r"^(  const float \w+ = )(\S+) / (\S+);$", re.M)
# ``a / b`` bit for bit, but where ``a`` is a zero and ``b`` a finite
# nonzero number the quotient is taken as ``a * b``, the same signed zero:
# the card's IEEE division sends a zero dividend down its slow path (a
# call, with the registers it clobbers saved), and a slack string's
# Jacobi corrections divide zeros nine times a segment
C_DIV = """\
PPI_QUAL float ppi_div(float a, float b) {
  if (a == 0.0f && fabsf(b) <= 0x1.fffffep+127f && b != 0.0f) return a * b;
  return a / b;
}
"""


def skip_zero_dividends(header: str) -> str:
    """``header`` (a generated body) with ``C_DIV`` defined and every
    division of its functions taken through ``ppi_div``: the same values,
    bit for bit."""
    header = header.replace(bic.C_HELPERS, bic.C_HELPERS + C_DIV, 1)
    return _DIVISION.sub(r"\1ppi_div(\2, \3);", header)


_LINE = re.compile(r"  const float (\w+) = (.*);")
_NAME = re.compile(r"\b(t\d+|[a-z][a-z_]*_\d+)\b")


def _emit_split(signatures, inputs, body, outputs, per_pass):
    """Two generated functions from one program, ``body(*arrays)`` on the
    ``inputs`` (as ``_emit``). A line that repeats an earlier line's
    operation on the same operands is dropped and its value taken from
    the earlier one: every operation is a pure f32 function of its
    operands, so the value is the same, bit for bit. Then the lines that
    read, directly or not, none of the inputs named in ``per_pass`` go
    into the first function (``signatures[0]``), the others into the
    second (``signatures[1]``); the first writes the values the second
    reads into its array ``sh``, the second binds them from its own
    ``sh``. ``outputs`` = (first's array, k, second's array): the first k
    values of the program are the first function's outputs (they must
    read no ``per_pass`` input), the rest the second's. Returns (text, the
    number of values in ``sh``)."""
    em = sm.Emitter()
    arrays = [tuple(em.input(f"{name}_{k}", f"{name}[{k}]")
                    for k in range(size)) for name, size in inputs]
    values = body(*arrays)
    alias, seen, lines = {}, {}, []
    for text in em.lines:
        name, expr = _LINE.fullmatch(text).groups()
        expr = _NAME.sub(lambda m: alias.get(m.group(1), m.group(1)), expr)
        if expr in seen:
            alias[name] = seen[expr]
            continue
        seen[expr] = name
        lines.append((name, expr))
    first_out, k_first, second_out = outputs
    out = [alias.get(v.name, v.name) if isinstance(v, sm.Sym)
           else sm._operand(v) for v in values]
    tainted = {f"{name}_{k}" for name, size in inputs if name in per_pass
               for k in range(size)}
    first, second = [], []
    for name, expr in lines:
        if name in tainted or tainted & set(_NAME.findall(expr)):
            tainted.add(name)
            second.append((name, expr))
        else:
            first.append((name, expr))
    if tainted & set(out[:k_first]):
        raise ValueError("a first output reads a per-pass input")
    read = set(out[k_first:])
    for _, expr in second:
        read.update(_NAME.findall(expr))
    sh = [name for name, _ in first if name in read]
    decl = "  const float {} = {};".format
    one = ([decl(n, e) for n, e in first]
           + [f"  {first_out}[{k}] = {v};" for k, v in enumerate(
               out[:k_first])]
           + [f"  sh[{k}] = {n};" for k, n in enumerate(sh)])
    two = ([decl(n, f"sh[{k}]") for k, n in enumerate(sh)]
           + [decl(n, e) for n, e in second]
           + [f"  {second_out}[{k}] = {v};"
              for k, v in enumerate(out[k_first:])])
    text = "\n".join(f"PPI_QUAL {sig} {{\n" + "\n".join(body_lines)
                     + "\n}\n" for sig, body_lines in zip(signatures,
                                                         (one, two)))
    return text, len(sh)


def generate_bic_header(sim) -> str:
    """C source of the kernel's body (``bic_body.h``) for ``sim``.
    Deterministic: the same sim gives the same text, which keys the
    build."""
    return _generate(sim)[0]


def ops_per_lane_step(sim) -> int:
    """f32 operations of one control step of one lane (``Emitter.ops``):
    the arm and the string twice with the same-step coupling, once
    without, and the statistics. Times N x steps it is the work of a
    launch, which bounds its time from below."""
    ops = _generate(sim)[1]
    passes = 2 if sim.same_step_coupling else 1
    return passes * (ops["arm"] + ops["string"]) + ops["commit"]


@functools.cache
def _generate(sim):
    L = sim.layout
    S, NSTR = L.size, L.str_size
    functions, ops = [], {}

    def reset_body(q0):
        out = list(sim.reset_soa(q0))
        out[L.MAX_POT] = None  # -inf: the skeleton writes it
        return out

    for name, sig, inputs, body, outputs in (
            ("reset", "void bic_reset(const float* q0, float* s)",
             [("q0", 4)], reset_body, "s"),
            ("arm", "void bic_arm(const float* s, const float* qdes, "
                    "const float* qddes, const float* reaction, float* arm)",
             [("s", S), ("qdes", 4), ("qddes", 4), ("reaction", 3)],
             sim.arm_soa, "arm"),
            ("string", "void bic_string(const float* s, const float* arm, "
                       "float* str)",
             [("s", S), ("arm", 8)], sim.string_soa, "str"),
            ("commit", "void bic_commit(float* s, const float* arm, "
                       "const float* str)",
             [("s", S), ("arm", 8), ("str", NSTR)], sim.commit_soa, "s"),
            ("score", "void bic_score(const float* s, float* score)",
             [("s", S)], lambda s: sim.score_soa(s), "score")):
        text, ops[name] = _emit(sig, inputs, body, outputs)
        functions.append(text)
    defines = [
        f"#define PPI_BIC_S {S}", f"#define PPI_BIC_NSTR {NSTR}",
        f"#define PPI_BIC_Q {L.Q}", f"#define PPI_BIC_FORCE {L.FORCE}",
        f"#define PPI_BIC_MAX_POT {L.MAX_POT}",
        f"#define PPI_BIC_SUM_VEL {L.SUM_VEL}",
        f"#define PPI_BIC_SUM_POS {L.SUM_POS}",
        f"#define PPI_BIC_SUM_BALL {L.SUM_BALL}",
        f"#define PPI_BIC_N_STEPS {L.N_STEPS}", f"#define PPI_BIC_Q0 {L.Q0}",
        f"#define PPI_BIC_STR_REACTION {L.STR_REACTION}",
        f"#define PPI_BIC_SAME_STEP {int(sim.same_step_coupling)}"]
    text = "\n".join([
        "/* Body of ppi_tpu_torch/csrc/bic_rollout.cu, generated by",
        "   ppi_tpu_torch/envs/physics/bic_kernel.py from the scalar program",
        f"   of envs/ball_in_a_cup.py ({sim.n_particles} particles, "
        f"{sim._effective_pbd_iterations} sweeps). Do not edit. */",
        *defines, "", sm.C_HELPERS, bic.C_HELPERS, *functions])
    return text, ops


# ---- the warp layout's header --------------------------------------------------

# a point of the string a lane: at most 31 particles and the anchor
MAX_WARP_POINTS = 32


def _lane0_state(L, a, ball=None):
    """A ``StateLayout``-indexed list holding lane 0's values ``a`` and the
    ball's position (the last particle): what ``arm_soa``, ``stats_soa``
    and ``score_soa`` read of a lane state. The warp layout keeps the lane
    state but the particles as ``a``, PPI_BIC_A floats: the coordinates
    (``StateLayout`` 0-7), then the reaction, the statistics and the
    position penalty's pose (``StateLayout.FORCE`` on)."""
    s = [None] * L.size
    for k, v in enumerate(a):
        s[k if k < 8 else L.FORCE + k - 8] = v
    if ball is not None:
        for c in range(3):
            s[L.PARTICLES + 3 * (L.n_points - 1) + c] = ball[c]
    return s


def generate_warp_header(sim) -> str:
    """C source of the warp layout's body (``bic_warp.h``) for ``sim``:
    the functions lane 0's values take (the arm, the cup frame, the
    reaction, the statistics, the score), those of each point and each
    segment (the prediction, the Jacobi correction, the sweep's sum, the
    cup contact, the reaction's term) and the per-lane constants they
    read. Every function runs the scalar program's helpers of
    ``envs/ball_in_a_cup.py``, so each value is computed by the same f32
    operations on the same operands as in ``generate_bic_header``'s
    unrolled body.

    What a step's two passes compute alike is computed once
    (``_emit_split``): of the arm, everything that does not read the
    string's reaction (the kinematics, the mass matrix and its
    elimination, the bias, the PD torque) in ``bicw_arm_shared``, the rest
    (``J^T F``, the right-hand side's sums, the solve's last column, the
    integration) in ``bicw_arm_pass``; and the statistics' kinematics at
    the new pose are the cup frame's, computed in ``bicw_frame``.
    Deterministic."""
    return _generate_warp(sim)


ARM_SIGNATURES = (
    "void bicw_arm_shared(const float* a, const float* qdes, "
    "const float* qddes, float* sh)",
    "void bicw_arm_pass(const float* sh, const float* a, const float* qdes, "
    "const float* qddes, const float* reaction, float* arm)")
FRAME_SIGNATURES = (
    "void bicw_frame(const float* arm, float* frame, float* sh)",
    "void bicw_stats(const float* sh, const float* arm, const float* frame, "
    "const float* a, const float* ball, const float* ball_prev, "
    "float* stats)")


@functools.cache
def _generate_warp(sim):
    L, n = sim.layout, sim.n_particles
    if L.n_points > MAX_WARP_POINTS:
        raise ValueError(f"{n} particles: the warp layout holds at most "
                         f"{MAX_WARP_POINTS} points, a point a lane")
    A = 8 + L.size - L.FORCE
    dt = sim.dt
    seg = sim._string_rest_lengths()
    w, masses, denom = sim._inverse_masses()

    def arm(a, qdes, qddes, r):
        return sim.arm_soa(_lane0_state(L, a), qdes, qddes, r)

    def frame(q):
        bottom, top, up = sim.cup_frame_soa(q)
        return bottom + top + up

    def stats(arm, f, a, ball, prev):
        return sim.stats_soa(_lane0_state(L, a, ball=prev), arm[:4],
                             arm[4:8], f[0:3], f[3:6], ball)

    arm_text, arm_sh = _emit_split(
        ARM_SIGNATURES, [("a", A), ("qdes", 4), ("qddes", 4),
                         ("reaction", 3)], arm, (None, 0, "arm"),
        ("reaction",))
    frame_text, frame_sh = _emit_split(
        FRAME_SIGNATURES, [("arm", 8), ("a", A), ("ball", 3),
                           ("ball_prev", 3)],
        lambda arm_, a, ball, prev: frame(arm_[:4]) + stats(
            arm_, frame(arm_[:4]), a, ball, prev), ("frame", 9, "stats"),
        ("a", "ball", "ball_prev"))

    def split(f):
        return (f[0:3], f[3:6], f[6:9])

    functions = [arm_text, frame_text]
    for sig, inputs, body, outputs in (
            ("void bicw_hang(const float* frame, const float* drop, "
             "float* p)", [("frame", 9), ("drop", 1)],
             lambda f, d: sim.hang_soa(f[0:3], d[0]), "p"),
            ("void bicw_predict(const float* p, const float* prev, "
             "float* pred)", [("p", 3), ("prev", 3)], sim.predict_soa,
             "pred"),
            ("void bicw_segment(const float* a, const float* b, "
             "const float* k, float* dadb)", [("a", 3), ("b", 3), ("k", 3)],
             lambda a, b, k: sum(sim.segment_soa(a, b, seg, *k), ()),
             "dadb"),
            ("void bicw_correct(const float* p, const float* da, "
             "const float* db, float* out)", [("p", 3), ("da", 3),
                                               ("db", 3)],
             sim.correct_soa, "out"),
            ("void bicw_correct_ball(const float* p, const float* db, "
             "float* out)", [("p", 3), ("db", 3)],
             lambda p, db: sim.correct_soa(p, None, db), "out"),
            ("void bicw_contact(const float* ball, const float* frame, "
             "float* out)", [("ball", 3), ("frame", 9)],
             lambda b, f: sim.contact_soa(b, split(f)), "out"),
            ("void bicw_term(const float* p, const float* part, "
             "const float* prev, const float* mass, float* term)",
             [("p", 3), ("part", 3), ("prev", 3), ("mass", 1)],
             lambda p, part, prev, m: tuple(
                 sim.reaction_term_soa(m[0], p[c], part[c], prev[c])
                 for c in range(3)), "term"),
            ("void bicw_reaction(const float* sums, float* reaction)",
             [("sums", 3)],
             lambda sums: sim.reaction_soa(tuple(x / dt for x in sums)),
             "reaction"),
            ("void bicw_score(const float* a, const float* ball, "
             "float* score)", [("a", A), ("ball", 3)],
             lambda a, ball: sim.score_soa(_lane0_state(L, a, ball=ball)),
             "score")):
        functions.append(_emit(sig, inputs, body, outputs)[0])

    def table(name, rows):
        body = ",\n  ".join("{" + ", ".join(sm.f32_literal(v) for v in row)
                            + "}" for row in rows)
        return (f"PPI_TABLE float {name}[PPI_BIC_NP][{len(rows[0])}] = "
                f"{{\n  {body}}};")

    # segment i's (w_i, w_i+1, denom_i) (the ball's row is not read), each
    # point's mass and its drop in the hanging string
    seg_k = [(w[i], w[i + 1], denom[i]) for i in range(n)] + [(0.0,) * 3]
    point = [(masses[i], sim.hang_drops()[i]) for i in range(n + 1)]
    defines = [
        f"#define PPI_BIC_S {L.size}", f"#define PPI_BIC_NP {L.n_points}",
        f"#define PPI_BIC_A {A}",
        f"#define PPI_BIC_SWEEPS {sim._effective_pbd_iterations}",
        f"#define PPI_BIC_PARTICLES {L.PARTICLES}",
        f"#define PPI_BIC_PREV {L.PREV}", f"#define PPI_BIC_FORCE {L.FORCE}",
        "#define PPI_BIC_A_FORCE 8",
        f"#define PPI_BIC_A_MAX_POT {8 + L.MAX_POT - L.FORCE}",
        f"#define PPI_BIC_A_SUM_VEL {8 + L.SUM_VEL - L.FORCE}",
        f"#define PPI_BIC_A_SUM_POS {8 + L.SUM_POS - L.FORCE}",
        f"#define PPI_BIC_A_SUM_BALL {8 + L.SUM_BALL - L.FORCE}",
        f"#define PPI_BIC_A_N_STEPS {8 + L.N_STEPS - L.FORCE}",
        f"#define PPI_BIC_A_VIOLATED {8 + L.VIOLATED - L.FORCE}",
        f"#define PPI_BIC_A_Q0 {8 + L.Q0 - L.FORCE}",
        f"#define PPI_BIC_ARM_SH {arm_sh}",
        f"#define PPI_BIC_FRAME_SH {frame_sh}",
        f"#define PPI_BIC_SAME_STEP {int(sim.same_step_coupling)}"]
    return skip_zero_dividends("\n".join([
        "/* Body of ppi_tpu_torch/csrc/bic_rollout_warp.cu, generated by",
        "   ppi_tpu_torch/envs/physics/bic_kernel.py from the scalar program",
        f"   of envs/ball_in_a_cup.py ({n} particles, "
        f"{sim._effective_pbd_iterations} sweeps). Do not edit. */",
        *defines, "", sm.C_HELPERS, bic.C_HELPERS,
        table("ppi_bic_seg_k", seg_k), table("ppi_bic_point", point), "",
        *functions]))


# ---- build ------------------------------------------------------------------

# each layout's skeleton, its generated header's name, and the symbols of
# its launch (pointers, ints, stream) and of its host-C build
SOURCES = {"thread": ("bic_rollout.cu", "bic_body.h"),
           "warp": ("bic_rollout_warp.cu", "bic_warp.h")}
LAUNCH_SYMBOLS = {"thread": "ppi_bic_launch", "warp": "ppi_bic_warp_launch"}
HOST_SYMBOLS = {"thread": "ppi_bic_host", "warp": "ppi_bic_warp_host"}


@functools.cache
def _library(header: str, host: bool = False, layout: str = "thread"):
    source, name = SOURCES[layout]
    return build_library(source, {name: header}, host=host)


def load_host_bic(header: str, layout: str = "thread"):
    """The host-C build of ``layout``'s skeleton + ``header``: ``fn(q_start,
    act, state_out, score, n, T, n_stab, n_cool)`` on pointers to
    C-contiguous f32 buffers in the kernel's layout."""
    return load_function(_library(header, host=True, layout=layout),
                         HOST_SYMBOLS[layout], 4, 4, stream=False)


def load_launch(lib, layout: str):
    """The launch of a build of ``layout``: ``fn(q_start, act, state,
    score, n, T, n_stab, n_cool, size, stream)``, ``size`` the threads
    (thread layout) or trajectories (warp layout) a block."""
    return load_function(lib, LAUNCH_SYMBOLS[layout], 4, 5, stream=True)


# ---- the plain version ------------------------------------------------------

def plain_bic_rollout(sim, q_start, actions):
    """What the kernel computes, eagerly over (N,) torch lanes: ``(q_start
    (4,), actions (N, T, 4)) -> (state (N, S), reward (N,), success
    (N,))`` with the actions' two position and two velocity channels
    driving joints 1 and 3 (``envs.episodic.BallInACup``), ``state`` the
    final lane states in ``StateLayout`` order (``violated`` as 0/1) and
    ``success`` 0/1."""
    qs, qds = joint_setpoints(actions)
    final = sim.execute_trajectory(q_start, qs, qds)
    reward, success = sim.reward_and_success(final)
    state = torch.stack(sim.scalars(final), -1)
    return state, reward, success.to(torch.float32)


def joint_setpoints(actions):
    """(N, T, 4) actions -> desired (q, qd) each (N, T, 4): the two
    position channels drive joints 1 and 3, the two velocity channels
    theirs; joints 0 and 2 hold 0."""
    n, t, _ = actions.shape
    qs = actions.new_zeros((n, t, 4))
    qds = actions.new_zeros((n, t, 4))
    qs[..., 1], qs[..., 3] = actions[..., 0], actions[..., 1]
    qds[..., 1], qds[..., 3] = actions[..., 2], actions[..., 3]
    return qs, qds


# ---- the wrapper ------------------------------------------------------------

def route(sim) -> str:
    """The layout ``make_bic_rollout`` launches for ``sim``: the warp layout
    (a point of the string a lane) where the string's points fit a warp's
    lanes, ``sim.n_particles + 1 <= MAX_WARP_POINTS``; the one-thread
    layout for a longer string. The warp layout was timed faster on the
    card for the canonical 12-particle string only (PERF.md section 6);
    longer strings and the lagged coupling were checked for bits, not
    timed."""
    return "warp" if sim.layout.n_points <= MAX_WARP_POINTS else "thread"


def make_bic_rollout(sim, layout=None):
    """Build ``run(q_start (4,), actions (N, T, 4)) -> (state (N, S),
    reward (N,), success (N,))``: on CUDA tensors one launch of the
    ball-in-a-cup kernel in ``layout`` (``route(sim)`` unless given:
    ``csrc/bic_rollout_warp.cu`` with ``WARPS`` trajectories a block, or
    ``csrc/bic_rollout.cu`` with ``BLOCK``), on CPU tensors the plain
    version. ``run.load()`` builds and loads the kernel (the first CUDA
    launch does it otherwise); ``run.layout`` names the layout."""
    layout = layout or route(sim)
    if layout not in SOURCES:
        raise ValueError(f"unknown ball-in-a-cup layout {layout!r}")
    if layout == "warp" and sim.layout.n_points > MAX_WARP_POINTS:
        raise ValueError(f"{sim.n_particles} particles do not fit the warp "
                         f"layout's {MAX_WARP_POINTS} lanes")
    fn = None
    size = sim.layout.size
    block = WARPS if layout == "warp" else BLOCK

    def load():
        header = (generate_warp_header(sim) if layout == "warp"
                  else generate_bic_header(sim))
        return load_launch(_library(header, layout=layout), layout)

    def run(q_start, actions):
        dev = actions.device
        if dev.type == "cpu":
            return plain_bic_rollout(sim, q_start, actions)
        if dev.type != "cuda":
            raise TypeError(f"no ball-in-a-cup kernel for {dev}")
        for name, x in (("q_start", q_start), ("actions", actions)):
            if x.device != dev or x.dtype != torch.float32:
                raise TypeError(f"{name}: expected float32 on {dev}, got "
                                f"{x.dtype} on {x.device}")
        n, t = actions.shape[:2]
        if q_start.shape != (4,) or actions.shape != (n, t, 4) \
                or n == 0 or t == 0:
            raise ValueError(f"shapes q_start {tuple(q_start.shape)}, "
                             f"actions {tuple(actions.shape)}; expected (4,) "
                             "and (N, T, 4) with N, T > 0")
        nonlocal fn
        if fn is None:
            fn = load()
        act = actions.permute(1, 2, 0).contiguous()     # (T, 4, N)
        q = q_start.contiguous()
        state = torch.empty((size, n), dtype=torch.float32, device=dev)
        score = torch.empty((2, n), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = fn(q.data_ptr(), act.data_ptr(), state.data_ptr(),
                     score.data_ptr(), n, t, sim.stabilize_steps,
                     sim.cooldown_steps, block,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ball-in-a-cup kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES[LAUNCH_KEYS[layout]] += 1
        return state.t(), score[0], score[1]

    run.load = load
    run.layout = layout
    return run
