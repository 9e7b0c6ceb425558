"""The ball-in-a-cup kernel: generator, build, wrapper, plain version.

The JAX package evaluates a batch of ball-in-a-cup trajectories as an XLA
scan under ``jax.vmap`` (``ppi_tpu/envs/episodic.py``, ``BallInACup.
evaluate``, over ``BallInCupSim.execute_trajectory`` at
``ppi_tpu/envs/ball_in_a_cup.py:341-372``); it has no Pallas kernel. Run
eagerly, one trajectory of 1,600 steps is some 30 million torch launches,
so the port gives it a kernel written by hand for Hopper: the skeleton
``csrc/bic_rollout.cu`` (one thread a trajectory, all three phases in one
launch, the lane's state in registers) around a body generated here from
the scalar program of ``envs/ball_in_a_cup.py``:

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

Built with ``nvcc`` for ``sm_90a`` (``-fmad=false``, as the rollout
bodies: each operation rounded once, as its plain version's eager ops) at
first use into ``build/kernels/<hash>/``, bound with ``ctypes``
(``ppi_tpu_torch/build.py``). The file also compiles as host C, which the
CPU tests run against the plain version.

The wrapper of ``make_bic_rollout`` takes the plain version
(``BallInCupSim.execute_trajectory`` and ``reward_and_success``, eagerly
over torch tensors) for CPU tensors only; on a CUDA tensor it launches the
kernel or raises. ``LAUNCHES["bic_rollout"]`` counts its launches.
"""

import functools

import torch

from ppi_tpu_torch.build import LAUNCHES, build_library, load_function
from ppi_tpu_torch.envs import ball_in_a_cup as bic
from ppi_tpu_torch.envs.physics import scalar_math as sm

LAUNCH_KEY = "bic_rollout"
# trajectories (threads) a block: 128 lanes are then 4 blocks on 4 SMs
BLOCK = 32


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


# ---- build ------------------------------------------------------------------

@functools.cache
def _library(header: str, host: bool = False):
    return build_library("bic_rollout.cu", {"bic_body.h": header}, host=host)


def load_host_bic(header: str):
    """The host-C build of the skeleton + ``header``: ``fn(q_start, act,
    state_out, score, n, T, n_stab, n_cool)`` on pointers to C-contiguous
    f32 buffers in the kernel's layout."""
    return load_function(_library(header, host=True), "ppi_bic_host", 4, 4,
                         stream=False)


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

def make_bic_rollout(sim):
    """Build ``run(q_start (4,), actions (N, T, 4)) -> (state (N, S),
    reward (N,), success (N,))``: on CUDA tensors one launch of
    ``csrc/bic_rollout.cu`` (``BLOCK`` trajectories a CUDA block), on CPU
    tensors the plain version. ``run.load()`` builds and loads the
    kernel (the first CUDA launch does it otherwise)."""
    fn = None
    size = sim.layout.size

    def load():
        lib = _library(generate_bic_header(sim))
        return load_function(lib, "ppi_bic_launch", 4, 5, stream=True)

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
                     sim.cooldown_steps, BLOCK,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ball-in-a-cup kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES[LAUNCH_KEY] += 1
        return state.t(), score[0], score[1]

    run.load = load
    return run
