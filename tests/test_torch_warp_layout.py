"""The rollout kernel's warp layout (csrc/rollout_warp.cu) on the CPU.

door-v0-adroit, hammer-v0-adroit, relocate-v0-adroit, door-v0-hand,
hammer-v0-hand and relocate-v0-hand (and pen-v0-adroit and fetch-pick,
tests/test_torch_warp_pivot.py) plan and step through the warp layout:
one rollout a warp, the substep split into ``engine_soa.assemble_soa``
(lane 0's straight-line ``env_assemble``, then the mass matrix and the
right-hand side summed across the lanes from generated tables), the
cooperative Gauss-Jordan solve and ``integrate_soa``. The skeleton also
compiles as host C, each cooperative stage run lane by lane; that build
is held to the lane layout's host-C build bit for bit, and to the plain
version within tests/test_torch_rollout.py's tolerances: torch's CPU
sin/cos are not the C library's (they differ in the last bit for ~5% of
f32 inputs), so neither host-C build equals the eager version bit for
bit. The solve alone takes only +, -, * and /, and equals
``solve_pd_scalar`` on torch bit for bit.
"""

import hashlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import (
    Q_TOL, REW_TOL, assert_rollout_close, hand_door_lanes,
    jax_lane_rollout_fn, port_state)
from torch_helpers import to_np, to_torch
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, assemble_soa, bias_wrench_soa, fk_soa, integrate_soa,
    jacobian_column, m3_vec, solve_pd_scalar, substep_soa,
    velocity_kinematics_soa, world_inertia_soa)
from ppi_tpu_torch.runners.run_mpc import ENVS, KERNEL_ENVS

WARP_ENVS = ("door-v0-adroit", "hammer-v0-adroit", "relocate-v0-adroit",
             "door-v0-hand", "hammer-v0-hand", "relocate-v0-hand")
# every env that plans and steps through the warp layout: the six above,
# and the two whose solve starts with a constant head
# (tests/test_torch_warp_pivot.py)
ROUTED_WARP_ENVS = WARP_ENVS + ("pen-v0-adroit", "fetch-pick")
# the envs that plan and step through the split layout
# (tests/test_torch_split_layout.py, tests/test_torch_split_subtree.py,
# tests/test_torch_split_chain.py)
ROUTED_SPLIT_ENVS = ("door-v0", "relocate-v0", "cheetah", "walker2d",
                     "walker~walk", "humanoid-standup", "pen-v0-hand",
                     "fetch-push", "hopper", "pen-v0", "reacher",
                     "finger~spin")
N, H = 5, 2

# sha256 of the warp headers as first generated: a change to the
# generator or the tables shows here, beside the lane pins of
# tests/test_torch_generator.py
WARP_SHA256 = {
    "door-v0-adroit":
        "d806588aafe3ed30fbfb4d0fa2747b41e6de2baa8b30827c451078e3fded6ed9",
    "hammer-v0-adroit":
        "bf91d6063fc7eeceaf2492d7de122dba1b388f9ceb043190b6ca607ab654ec50",
    "relocate-v0-adroit":
        "65b169325486ac35e33e2184490ba80ac84079336dd2c336b9f34fdc2dab13b8",
    "door-v0-hand":
        "068107eb5dcded245ea594ae77ece5f242237608e597a8f646126536453dffc5",
    "hammer-v0-hand":
        "19b7a3b13ffbd97a6ddb56ddc6191f095d648a538bceeff453935e8523d19742",
    "relocate-v0-hand":
        "31a869d73b18d0dae8ff952d99b71a1da622bba4394d28192a0c1bca069a861f",
}


def _needs_cc():
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")


def _state(name, seed=0):
    return ENVS[name]().reset(torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(scope="module")
def headers():
    """name -> (lane header, warp header) from the seed-0 state."""
    out = {}
    for name in WARP_ENVS:
        args = rk.body_args(ENVS[name](), _state(name))
        out[name] = (rk.generate_env_header(*args),
                     rk.generate_warp_header(*args))
    return out


@pytest.fixture(scope="module")
def builds(headers):
    """name -> (lane host-C function, warp host-C function): one build
    each for the whole module."""
    _needs_cc()
    return {name: (rk.load_host_rollout(lane),
                   rk.load_host_warp_rollout(warp))
            for name, (lane, warp) in headers.items()}


def _lanes(name, state, n=N, h=H, seed=3):
    """The state's posture with a small spread in every lane, velocities
    and PD targets about the posture from a numpy seed."""
    env = ENVS[name]()
    rng = np.random.default_rng(seed)
    nq = env._model.nq
    q0 = (np.tile(to_np(state.physics.qpos), (n, 1))
          + 0.02 * rng.standard_normal((n, nq))).astype(np.float32)
    qd0 = (0.2 * rng.standard_normal((n, nq))).astype(np.float32)
    acts = (q0[:, None, :env.action_dim] + 0.3 * rng.standard_normal(
        (n, h, env.action_dim))).astype(np.float32)
    return q0, qd0, acts


SENTINEL = np.float32(-12345.0)
PAD = 7


def _host_run(fn, env, state, q0, qd0, acts):
    """(rewards (N,H), qf (N,nq), qdf (N,nq)) of a host-C build, its
    output buffers padded with a sentinel that must stay untouched."""
    n, h = acts.shape[0], acts.shape[1]
    nq = q0.shape[1]
    consts, _, dyn = rk.kernel_operands(env, state)
    q0_t, qd0_t = np.ascontiguousarray(q0.T), np.ascontiguousarray(qd0.T)
    act_t = np.ascontiguousarray(acts.transpose(1, 2, 0))
    c = None if consts is None else np.ascontiguousarray(to_np(consts))
    d = None if dyn is None else np.ascontiguousarray(to_np(dyn))
    rew = np.full(h * n + PAD, SENTINEL, np.float32)
    qf = np.full(nq * n + PAD, SENTINEL, np.float32)
    qdf = np.full(nq * n + PAD, SENTINEL, np.float32)
    ptr = lambda a: None if a is None else a.ctypes.data
    assert fn(ptr(q0_t), ptr(qd0_t), ptr(act_t), ptr(d), ptr(c), ptr(rew),
              ptr(qf), ptr(qdf), n, h) == 0
    for buf in (rew, qf, qdf):
        assert np.array_equal(buf[-PAD:], np.full(PAD, SENTINEL)), \
            "a write past the last rollout"
    return (rew[:h * n].reshape(h, n).T, qf[:nq * n].reshape(nq, n).T,
            qdf[:nq * n].reshape(nq, n).T)


def _bits(x):
    return np.ascontiguousarray(x).view(np.int32)


def _assert_same_bits(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("name", WARP_ENVS)
def test_stages_compose_to_the_substep(name):
    """assemble_soa -> solve_pd_scalar -> integrate_soa is substep_soa bit
    for bit, on eager torch at N=8; the helpers that the warp layout's
    stages trace (world inertia, Jacobian column, bias wrench) give
    assemble_soa's per-body values bit for bit."""
    env = ENVS[name]()
    state = _state(name)
    m = SoaModel(env._model)
    _, dyn_body, dyn = rk.kernel_operands(env, state)
    if dyn_body is not None:
        m = m.with_body_offset(dyn_body, dyn.unbind(-1))
    q0, qd0, acts = _lanes(name, state, n=8, h=1)
    q, qd = to_torch(q0).unbind(-1), to_torch(qd0).unbind(-1)
    tau = env.scalar_torque(m, q, qd, to_torch(acts[:, 0]).unbind(-1))
    h = env.dt / env.substeps
    a = assemble_soa(m, q, qd, tau)
    q2, qd2 = integrate_soa(m, q, qd, solve_pd_scalar(a.mass, a.rhs),
                            a.mdiag, h)
    q_ref, qd_ref = substep_soa(m, q, qd, tau, h)
    for x, y in zip(q2 + qd2, q_ref + qd_ref):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    rots, poss, axes, coms = fk_soa(m, q)
    omega, _, _, alpha, _, a_c = velocity_kinematics_soa(m, q, qd, rots,
                                                         poss, axes, coms)
    same = lambda x, y: torch.equal(torch.as_tensor(x).view(torch.int32),
                                    torch.as_tensor(y).view(torch.int32))
    for b in range(m.nq):
        i_w = world_inertia_soa(m, b, rots[b])
        for j in a.iw_jw[b]:
            assert all(map(same, m3_vec(i_w, a.jw[b][j]), a.iw_jw[b][j]))
        for j in m.ancestors[b]:
            jv, jw = jacobian_column(m, j, axes[j], poss[j], coms[b])
            assert all(map(same, jv, a.jv[b][j]))
            assert (jw is None) == (a.jw[b][j] is None)
            assert jw is None or all(map(same, jw, a.jw[b][j]))
        f, n = bias_wrench_soa(m, b, i_w, omega[b], alpha[b], a_c[b])
        assert all(map(same, f, a.f_bias[b]))
        assert all(map(same, n, a.n_bias[b]))


def _spd(nq, seed):
    """A random SPD matrix with the ancestor-sparse zeros of a hand (two
    branches that share only the first joints) and a right-hand side."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nq, nq)).astype(np.float64)
    mat = a @ a.T / nq + np.eye(nq) * rng.uniform(0.05, 2.0, nq)
    half = nq // 2
    mat[half + 2:, 4:half] = mat[4:half, half + 2:] = 0.0
    mat = mat + np.eye(nq) * (np.abs(mat).sum(1))   # diagonally dominant
    return mat.astype(np.float32), rng.standard_normal(nq).astype(np.float32)


@pytest.mark.parametrize("name", WARP_ENVS)
def test_cooperative_solve_equals_solve_pd_scalar(headers, name):
    """The skeleton's solve (lane c owns column c, dead columns skipped),
    host C, against ``solve_pd_scalar`` over torch at each warp env's nq
    (10 to 25), on four SPD matrices each: bit for bit."""
    _needs_cc()
    fn = rk.load_host_warp_solve(headers[name][1])
    nq = ENVS[name]()._model.nq
    for seed in range(4):
        mat, rhs = _spd(nq, seed)
        aug = np.ascontiguousarray(np.concatenate([mat, rhs[:, None]], 1))
        assert fn(aug.ctypes.data) == 0
        ref = solve_pd_scalar(
            [[torch.tensor([mat[i, j]]) for j in range(nq)]
             for i in range(nq)],
            tuple(torch.tensor([v]) for v in rhs))
        ref = np.array([float(x) for x in ref], np.float32)
        np.testing.assert_array_equal(_bits(aug[:, nq]), _bits(ref))
        np.testing.assert_allclose(aug[:, nq], np.linalg.solve(
            mat.astype(np.float64), rhs.astype(np.float64)), rtol=1e-3,
            atol=1e-5)


@pytest.mark.parametrize("name", WARP_ENVS)
def test_host_c_warp_build_equals_lane_build(builds, name):
    """N=5, H=2 from the seed-0 state: the warp build's rewards and final
    state are the lane build's bit for bit and the plain version's within
    the rollout tolerances; no write past the last rollout; a NaN lane
    poisons only its own rewards; the horizon mask; a second frame or
    board (``dyn``) or a second goal (the reward constants ``consts``)
    changes the rewards and the two builds still agree."""
    env, state = ENVS[name](), _state(name)
    lane, warp = builds[name]
    q0, qd0, acts = _lanes(name, state)
    got = _host_run(warp, env, state, q0, qd0, acts)
    _assert_same_bits(got, _host_run(lane, env, state, q0, qd0, acts))
    plain = [to_np(x) for x in rk.env_plain_rollout(
        env, state, to_torch(q0), to_torch(qd0), to_torch(acts))]
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], plain[0], **REW_TOL)
    np.testing.assert_allclose(got[1], plain[1], **Q_TOL)
    np.testing.assert_allclose(got[2], plain[2], **REW_TOL)

    bad = q0.copy()
    bad[2, 1] = np.nan
    rew_bad, _, _ = _host_run(warp, env, state, bad, qd0, acts)
    assert np.isnan(rew_bad[2]).all()
    keep = np.arange(N) != 2
    np.testing.assert_array_equal(_bits(rew_bad[keep]), _bits(got[0][keep]))

    mask = np.array([1.0, 0.0], np.float32)
    masked = rk.risk_aggregate(to_torch(got[0]), to_torch(mask))
    np.testing.assert_allclose(to_np(masked), -got[0][:, 0], rtol=1e-6)

    second = _state(name, seed=2)
    ops0, ops1 = rk.kernel_operands(env, state), rk.kernel_operands(env,
                                                                    second)
    k = 2 if ops0[2] is not None else 0   # dyn, else consts
    assert ops0[k] is not None and not torch.equal(ops1[k], ops0[k])
    got1 = _host_run(warp, env, second, q0, qd0, acts)
    _assert_same_bits(got1, _host_run(lane, env, second, q0, qd0, acts))
    assert not np.array_equal(got1[0], got[0])


def test_door_adroit_warp_build_matches_jax(builds):
    """door-v0-adroit's warp build against JAX's ``DoorAdroit(engine=
    "tensor")`` at N=8, H=2 on door-v0-hand's lanes (clamped, free and
    reset lanes): rewards within REW_TOL."""
    from ppi_tpu.envs.door_adroit import DoorAdroit as JaxDoorAdroit
    from ppi_tpu_torch.envs.door_adroit import DoorAdroitState
    jenv = JaxDoorAdroit(engine="tensor")
    env = ENVS["door-v0-adroit"]()
    js, q0, qd0, acts, _, _ = hand_door_lanes(jenv, env, 8, 2)
    ref = jax_lane_rollout_fn(jenv)(js, q0, qd0, acts)
    state = port_state(DoorAdroitState, js)
    got = _host_run(builds["door-v0-adroit"][1], env, state,
                    q0.astype(np.float32), qd0.astype(np.float32), acts)
    np.testing.assert_allclose(got[0], ref[0], **REW_TOL)


def test_door_hand_warp_build_matches_jax(builds):
    """door-v0-hand's warp build (12 DoF: 13 columns, lanes 13-31 idle in
    the solve) against JAX's ``DoorHand(engine="tensor")`` at N=8, H=2 on
    its clamped, free and reset lanes: tests/test_torch_door_hand.py's
    tolerances (REW_TOL, Q_TOL)."""
    from ppi_tpu.envs.door_hand import DoorHand as JaxDoorHand
    from ppi_tpu_torch.envs.door_hand import DoorHandState
    jenv = JaxDoorHand(engine="tensor")
    env = ENVS["door-v0-hand"]()
    js, q0, qd0, acts, _, _ = hand_door_lanes(jenv, env, 8, 2)
    ref = jax_lane_rollout_fn(jenv)(js, q0, qd0, acts)
    got = _host_run(builds["door-v0-hand"][1], env,
                    port_state(DoorHandState, js), q0.astype(np.float32),
                    qd0.astype(np.float32), acts)
    assert_rollout_close(got, ref)


def test_relocate_adroit_warp_build_matches_jax(builds):
    """relocate-v0-adroit's warp build (the goal through ``consts``, the
    ball a three-slide chain of its own) against JAX's
    ``RelocateAdroit(engine="tensor")`` at N=8, H=2 from a pinned goal, the
    ball on the table, sliding into the thumb and falling beside the
    fingers: tests/test_torch_relocate_adroit.py's tolerances (REW_TOL,
    Q_TOL)."""
    from ppi_tpu.envs.relocate_adroit import (
        RelocateAdroit as JaxRelocateAdroit)
    from ppi_tpu_torch.envs.relocate_adroit import (
        BALL_X, BALL_Y, BALL_Z, N_ACT, RelocateAdroitState)
    jenv = JaxRelocateAdroit(engine="tensor")
    env = ENVS["relocate-v0-adroit"]()
    js = jenv.reset(jax.random.key(0)).replace(
        target=jnp.asarray((0.65, 0.10, 0.88), jnp.float32))
    q = np.asarray(js.physics.qpos).copy()
    q[BALL_X], q[BALL_Y] = 0.02, -0.03
    q0 = np.tile(q, (8, 1)).astype(np.float32)
    qd0 = np.zeros_like(q0)
    qd0[3:6, BALL_Y] = -2.0
    q0[6:, BALL_Y], q0[6:, BALL_Z] = 0.2, 0.1
    acts = (q0[:, None, :N_ACT] + 0.3 * np.random.default_rng(0)
            .standard_normal((8, 2, N_ACT))).astype(np.float32)
    ref = jax_lane_rollout_fn(jenv)(js, q0, qd0, acts)
    got = _host_run(builds["relocate-v0-adroit"][1], env,
                    port_state(RelocateAdroitState, js), q0, qd0, acts)
    assert np.isfinite(got[0]).all()
    assert_rollout_close(got, ref)


def test_hammer_hand_warp_build_matches_jax(builds):
    """hammer-v0-hand's warp build (10 DoF, the board through ``dyn``)
    against JAX's ``HammerHand(engine="tensor")`` at N=8, H=3 on
    tests/test_torch_hammer_hand.py's lanes: the free hammer resting on the
    bench, and its head over the nail, falling at 2 m/s (the strike, the
    nail's friction clip). That file's host-C tolerance, 1e-4 relative and
    absolute: the impact amplifies libm's one-ulp sin/cos (measured 1.6e-6
    in the rewards, 2.3e-6 in the positions, 7.2e-5 in a struck hammer's
    velocity)."""
    from ppi_tpu.envs.hammer_hand import HammerHand as JaxHammerHand
    from ppi_tpu_torch.envs.hammer_hand import (
        GRIP_START, HAM_X, HAM_Z, HEAD_LOCAL, N_ACT, NAIL, NAIL_X,
        HammerHandState)
    jenv = JaxHammerHand(engine="tensor")
    js = jenv.reset(jax.random.key(0))
    n = 8
    q0 = np.tile(np.asarray(js.physics.qpos), (n, 1)).astype(np.float32)
    qd0 = np.zeros_like(q0)
    head_z = float(js.board[2]) + 0.06 + 0.018 + 0.045 + 0.01
    q0[n // 2:, HAM_X] = NAIL_X - HEAD_LOCAL[0] - GRIP_START[0]
    q0[n // 2:, HAM_Z] = head_z - HEAD_LOCAL[2] - GRIP_START[1]
    qd0[n // 2:, HAM_Z] = -2.0
    acts = (q0[:, None, :N_ACT] + 0.3 * np.random.default_rng(0)
            .standard_normal((n, 3, N_ACT))).astype(np.float32)
    ref = jax_lane_rollout_fn(jenv)(js, q0, qd0, acts)
    got = _host_run(builds["hammer-v0-hand"][1], ENVS["hammer-v0-hand"](),
                    port_state(HammerHandState, js), q0, qd0, acts)
    assert np.all(got[1][n // 2:, NAIL] > 0.0)   # the strike drove the nail
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)


def test_relocate_hand_warp_build_matches_jax(builds):
    """relocate-v0-hand's warp build (13 DoF, the goal through ``consts``)
    against JAX's ``RelocateHand(engine="tensor")`` at N=8, H=2 from a
    pinned goal: the ball resting on the table, sliding along it at 2 m/s,
    and falling into the open hand from 7 cm (REW_TOL, Q_TOL; measured
    1.8e-7 in the rewards, 2.2e-7 in the positions, 7.5e-6 in the
    velocities)."""
    from ppi_tpu.envs.relocate_hand import RelocateHand as JaxRelocateHand
    from ppi_tpu_torch.envs.relocate_hand import (
        BALL_X, BALL_Y, BALL_Z, N_ACT, RelocateHandState)
    jenv = JaxRelocateHand(engine="tensor")
    js = jenv.reset(jax.random.key(0)).replace(
        target=jnp.asarray((0.55, 0.15, 0.85), jnp.float32))
    q = np.asarray(js.physics.qpos).copy()
    q[BALL_X], q[BALL_Y] = 0.02, -0.03
    q0 = np.tile(q, (8, 1)).astype(np.float32)
    qd0 = np.zeros_like(q0)
    qd0[3:6, BALL_Y] = -2.0
    q0[6:, BALL_Z] = 0.07
    acts = (q0[:, None, :N_ACT] + 0.3 * np.random.default_rng(0)
            .standard_normal((8, 2, N_ACT))).astype(np.float32)
    ref = jax_lane_rollout_fn(jenv)(js, q0, qd0, acts)
    got = _host_run(builds["relocate-v0-hand"][1], ENVS["relocate-v0-hand"](),
                    port_state(RelocateHandState, js), q0, qd0, acts)
    assert np.isfinite(got[0]).all()
    assert np.all(np.abs(got[1][3:6, BALL_Y] - q0[3:6, BALL_Y]) > 1e-3)
    assert_rollout_close(got, ref)


def test_the_six_warp_envs_and_only_they_build_the_warp_layout(monkeypatch):
    """A spy on the build: ``env_rollout(...).load()`` builds the warp
    skeleton for the warp envs (door-v0-adroit, hammer-v0-adroit,
    relocate-v0-adroit, door-v0-hand, hammer-v0-hand, relocate-v0-hand,
    pen-v0-adroit and fetch-pick), the split skeleton for the split envs
    (door-v0, tests/test_torch_split_layout.py; relocate-v0, cheetah,
    walker2d, walker~walk, humanoid-standup and pen-v0-hand,
    tests/test_torch_split_subtree.py; fetch-push and hopper,
    tests/test_torch_split_chain.py) and the lane skeleton for every
    other env of the runner, hammer-v0 included."""
    built = {}
    monkeypatch.setattr(rk, "_env_header", lambda *a: "lane")
    monkeypatch.setattr(rk, "_warp_header", lambda *a: "warp")
    monkeypatch.setattr(rk, "_split_header", lambda *a: "split")
    monkeypatch.setattr(rk, "_library", lambda header: built.setdefault(
        "current", []).append(("rollout.cu", header)))
    monkeypatch.setattr(rk, "_warp_library", lambda header: built.setdefault(
        "current", []).append(("rollout_warp.cu", header)))
    monkeypatch.setattr(rk, "_split_library", lambda header: built.setdefault(
        "current", []).append(("rollout_split.cu", header)))
    monkeypatch.setattr(rk, "load_function", lambda *a, **k: a[1])
    table = {"lane": ("rollout.cu", "ppi_rollout_launch", "rollout"),
             "warp": ("rollout_warp.cu", "ppi_rollout_warp_launch",
                      "rollout_warp"),
             "split": ("rollout_split.cu", "ppi_rollout_split_launch",
                       "rollout_split")}
    for name, cls in KERNEL_ENVS.items():
        env = cls()
        built["current"] = []
        symbol = rk.env_rollout(env, env.reset(
            torch.Generator().manual_seed(0), "cpu"), 1).load()
        want = ("warp" if name in ROUTED_WARP_ENVS
                else "split" if name in ROUTED_SPLIT_ENVS else "lane")
        source, launch, key = table[want]
        assert built["current"] == [(source, want)], name
        assert symbol == launch
        assert rk.kernel_layout(env) == want
        assert rk.launch_key(env) == key
    assert len(KERNEL_ENVS) == 21


@pytest.mark.parametrize("name", sorted(set(KERNEL_ENVS) - set(WARP_ENVS)))
def test_which_bodies_the_warp_generator_takes(name):
    """The warp generator takes every body of the runner outside the six
    pinned below, none declined: fetch-pick, pen-v0-adroit, relocate-v0,
    door-v0, the other small ones, and the eight whose first pivot folds
    to a constant (cheetah, hopper, humanoid-standup, pen-v0,
    pen-v0-adroit, pen-v0-hand, walker2d, walker~walk), whose solve starts
    with its constant head."""
    header = rk.generate_warp_header(*rk.body_args(ENVS[name](),
                                                   _state(name)))
    assert "env_assemble" in header


@pytest.mark.parametrize("name", WARP_ENVS)
def test_warp_headers_are_unchanged(headers, name):
    warp = headers[name][1]
    assert "env_assemble" in warp and "env_substep" not in warp
    assert hashlib.sha256(warp.encode()).hexdigest() == WARP_SHA256[name]
