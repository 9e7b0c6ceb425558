"""Shared pieces of the per-env comparison tests of the torch port
(tests/test_torch_{pen,relocate,cheetah,door_hand,door_adroit,hammer,
pen_hand,relocate_hand,hammer_hand,reacher,finger,push,fetch_pick,
locomotion,pen_adroit,relocate_adroit,hammer_adroit}.py).

The JAX reference is ``ppi_tpu.envs.base.batch_rollout`` (the scan path
that tests/test_pallas_rollout.py holds the Pallas kernel to), jitted once
per env; the env's state is a traced argument, so each further goal or
start reuses the compiled program. ``jax_lane_rollout_fn`` is the same
scan from a different initial state in each lane. The port's state is the
JAX state carried across as numpy (``convert.env_state_from_numpy``).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np, to_torch
from ppi_tpu.envs.base import batch_rollout as jax_batch_rollout
from ppi_tpu.envs.base import rollout as jax_rollout
from ppi_tpu.envs.physics import PhysicsState as JaxPhysicsState
from ppi_tpu_torch.convert import env_state_from_numpy
from ppi_tpu_torch.envs.physics.engine import MODEL_FIELDS
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    body_args, env_plain_rollout, env_rollout, generate_env_header,
    kernel_operands, load_host_rollout)

# tests/test_torch_rollout.py's tolerances: rewards and velocities 1e-5
# relative and absolute, positions 1e-6 absolute
REW_TOL = dict(rtol=1e-5, atol=1e-5)
Q_TOL = dict(rtol=1e-5, atol=1e-6)


def jax_rollout_fn(jenv):
    """``run(jax state, actions (N,H,d_a)) -> (rewards, qf, qdf)`` as numpy,
    one jit of the JAX batch_rollout."""
    fn = jax.jit(lambda s, a: jax_batch_rollout(jenv, s, a))

    def run(jstate, acts):
        final, rew = fn(jstate, jnp.asarray(acts))
        return (np.asarray(rew), np.asarray(final.physics.qpos),
                np.asarray(final.physics.qvel))

    return run


def jax_lane_rollout_fn(jenv):
    """``run(jax state, q0 (N,nq), qd0 (N,nq), actions (N,H,d_a)) ->
    (rewards, qf, qdf)`` as numpy: lane i starts from (q0[i], qd0[i]) and
    the state's other fields (the frame); one jit."""
    fn = jax.jit(jax.vmap(
        lambda q, qd, a, s: jax_rollout(
            jenv, s.replace(physics=JaxPhysicsState(qpos=q, qvel=qd)), a),
        in_axes=(0, 0, 0, None)))

    def run(jstate, q0, qd0, acts):
        final, rew = fn(jnp.asarray(q0), jnp.asarray(qd0), jnp.asarray(acts),
                        jstate)
        return (np.asarray(rew), np.asarray(final.physics.qpos),
                np.asarray(final.physics.qvel))

    return run


def state_fields(jstate) -> dict:
    """A JAX env state's fields as numpy, physics flattened to qpos/qvel."""
    out = {}
    for k in jstate.__dataclass_fields__:
        v = getattr(jstate, k)
        if k == "physics":
            out["qpos"], out["qvel"] = np.asarray(v.qpos), np.asarray(v.qvel)
        else:
            out[k] = np.asarray(v)
    return out


def port_state(state_cls, jstate):
    return env_state_from_numpy(state_cls, state_fields(jstate), "cpu")


def wrapper_run(env, state, acts, q0=None, qd0=None):
    """The rollout wrapper's CPU path (the plain version) from ``state``:
    (rewards, qf, qdf) as numpy."""
    n, horizon = acts.shape[0], acts.shape[1]
    consts, _, dyn = kernel_operands(env, state)
    run = env_rollout(env, state, horizon)
    q0 = state.physics.qpos.expand(n, -1) if q0 is None else to_torch(q0)
    qd0 = state.physics.qvel.expand(n, -1) if qd0 is None else to_torch(qd0)
    return tuple(to_np(x) for x in run(q0, qd0, to_torch(acts),
                                       consts=consts, dyn=dyn))


def assert_rollout_close(got, ref):
    rew, qf, qdf = got
    np.testing.assert_allclose(rew, ref[0], **REW_TOL)
    np.testing.assert_allclose(qf, ref[1], **Q_TOL)
    np.testing.assert_allclose(qdf, ref[2], **REW_TOL)


def assert_model_equals_reference(jenv, env):
    for field in MODEL_FIELDS:
        ref = np.asarray(getattr(jenv._model, field))
        got = getattr(env._model, field)
        assert got.dtype == ref.dtype and got.shape == ref.shape, field
        np.testing.assert_array_equal(got, ref, err_msg=field)
    assert env._model.parents == jenv._model.parents
    assert env._model.joint_types == jenv._model.joint_types


def assert_host_c_matches_plain(env, state, acts, q0, qd0, tol=None):
    """The skeleton plus the env's generated body, built as host C, against
    the plain version on the same lanes (NaN lanes included), within
    ``tol`` (REW_TOL unless given)."""
    tol = REW_TOL if tol is None else tol
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    n, h = acts.shape[0], acts.shape[1]
    consts, _, dyn = kernel_operands(env, state)
    rew_p, qf_p, qdf_p = (to_np(x) for x in env_plain_rollout(
        env, state, to_torch(q0), to_torch(qd0), to_torch(acts)))
    fn = load_host_rollout(generate_env_header(*body_args(env, state)))
    nq = q0.shape[1]
    q0_t, qd0_t = np.ascontiguousarray(q0.T), np.ascontiguousarray(qd0.T)
    act_t = np.ascontiguousarray(acts.transpose(1, 2, 0))
    c = None if consts is None else np.ascontiguousarray(to_np(consts))
    d = None if dyn is None else np.ascontiguousarray(to_np(dyn))
    rew = np.empty((h, n), np.float32)
    qf, qdf = np.empty((nq, n), np.float32), np.empty((nq, n), np.float32)
    ptr = lambda a: None if a is None else a.ctypes.data
    assert fn(ptr(q0_t), ptr(qd0_t), ptr(act_t), ptr(d), ptr(c), ptr(rew),
              ptr(qf), ptr(qdf), n, h) == 0
    np.testing.assert_allclose(rew.T, rew_p, **tol)
    np.testing.assert_allclose(qf.T, qf_p, **tol)
    np.testing.assert_allclose(qdf.T, qdf_p, **tol)
    assert np.array_equal(np.isnan(rew.T), np.isnan(rew_p))


def assert_nan_lane_goes_nan_alone(env, state, acts, q0=None, qd0=None,
                                   lane: int = 2, clean=None):
    """A lane that starts from a NaN coordinate gets NaN rewards at every
    step; every other lane's rewards are bit for bit those of the clean
    run (``clean``: its rewards, if at hand)."""
    n = acts.shape[0]
    if q0 is None:
        q0 = np.tile(to_np(state.physics.qpos), (n, 1))
    bad = q0.copy()
    bad[lane, 1] = np.nan
    rew, _, _ = wrapper_run(env, state, acts, bad, qd0)
    if clean is None:
        clean, _, _ = wrapper_run(env, state, acts, q0, qd0)
    assert np.isnan(rew[lane]).all()
    keep = np.arange(n) != lane
    assert np.isfinite(clean).all()
    np.testing.assert_array_equal(rew[keep], clean[keep])


def mpc_episode_pair(jenv, env, algorithm, policy, policy_kwargs,
                     solver_kwargs, n_samples, horizon, timesteps, n_iters,
                     anneal, warm_iters: int = 2):
    """The same short MPC episode through the JAX agent and the port's, on
    the CPU, from the same base draws (``draw_base`` of both packages
    returns one numpy sample): ((JAX track, JAX final state), (track, final
    state)). Both envs must pin their scene (``fixed_scene`` /
    ``fixed_goal``), so both resets give the same state."""
    import ppi_tpu.policies.primitives as jax_primitives
    import ppi_tpu_torch.policies.primitives as primitives
    from ppi_tpu.algorithms import make_solver as jax_make_solver
    from ppi_tpu.mpc import Mpc as JaxMpc
    from ppi_tpu.policies import design_moments as jax_design_moments
    from ppi_tpu.policies import make_policy as jax_make_policy
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.mpc import Mpc
    from ppi_tpu_torch.policies import design_moments, make_policy
    d_a = env.action_dim
    jm, jci, jco = jax_design_moments(jenv.action_low, jenv.action_high,
                                      1000.0)
    jfam, jpol = jax_make_policy(
        policy, jenv.dt * jnp.arange(horizon), d_a, jm, jci, jco,
        lower=jenv.action_low, upper=jenv.action_high, **policy_kwargs)
    jagent = JaxMpc(env=jenv, solver=jax_make_solver(
        algorithm, dimension=jfam.dim_features, **solver_kwargs),
        family=jfam, timesteps=timesteps, horizon=horizon,
        n_samples=n_samples, n_iters=n_iters, anneal=anneal,
        use_pallas=False)
    m, ci, co = design_moments(env.action_low, env.action_high, 1000.0)
    fam, pol = make_policy(
        policy, env.dt * torch.arange(horizon), d_a, m, ci, co,
        lower=env.action_low, upper=env.action_high, device="cpu",
        **policy_kwargs)
    agent = Mpc(env=env, solver=make_solver(
        algorithm, dimension=fam.dim_features, **solver_kwargs), family=fam,
        timesteps=timesteps, horizon=horizon, n_samples=n_samples,
        n_iters=n_iters, anneal=anneal, device="cpu")
    z = np.random.default_rng(0).standard_normal(
        (n_samples, fam.dim_sample)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_primitives, "draw_base",
                   lambda kind, key, n, dim: jnp.asarray(z))
        mp.setattr(primitives, "draw_base",
                   lambda kind, gen, n, dim, device: to_torch(z))
        jcarry = jagent.init(jpol, jax.random.key(0))
        js = jenv.reset(jax.random.key(0))
        jcarry, _ = jagent.warm_start(jcarry, js, warm_iters)
        _, jfinal, jtrack = jagent.run_episode(jcarry, js)
        carry = agent.init(pol, torch.Generator().manual_seed(0))
        s = env.reset(None, "cpu")
        carry, _ = agent.warm_start(carry, s, warm_iters)
        _, final, track = agent.run_episode(carry, s)
    return (jtrack, jfinal), (track, final)


# ---- the 3-digit hand scenes (tests/test_torch_{pen,relocate,hammer}_hand.py)

def lane_states(state, q0, qd0):
    """``state`` with the physics of every lane: the batched state that the
    port's eager ``step`` runs over."""
    return dataclasses.replace(state, physics=dataclasses.replace(
        state.physics, qpos=to_torch(q0), qvel=to_torch(qd0)))


def assert_step_rollout_matches(env, state, q0, qd0, acts, reference):
    """The port's env step over N lanes (on the CPU, the eager step)
    against the reference rollout; the step count advances."""
    from ppi_tpu_torch.envs.base import rollout
    final, rew = rollout(env, lane_states(state, q0, qd0), to_torch(acts))
    assert_rollout_close((to_np(rew), to_np(final.physics.qpos),
                          to_np(final.physics.qvel)), reference)
    assert int(final.t) == acts.shape[1]


def assert_kernel_step_is_the_eager_step(env, state, q, action):
    """On the CPU ``step``, ``kernel_step`` and ``plain_step`` are one
    program."""
    from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_step
    s = lane_states(state, q, np.zeros_like(q))
    s1, r1 = env.step(s, to_torch(action))
    qn, qdn, r2 = kernel_step(env, s, to_torch(action))
    s3, r3 = env.plain_step(s, to_torch(action))
    assert r2.shape == () and int(s1.t) == 1
    assert torch.equal(qn, s1.physics.qpos) and torch.equal(qdn, s1.physics.qvel)
    assert torch.equal(r1, r2) and torch.equal(r1, r3)
    assert torch.equal(s3.physics.qpos, s1.physics.qpos)


def assert_steps_through_env_step(env, state, q, action):
    """``env.step`` is ``rollout_kernel.env_step`` (one launch on a CUDA
    state) and ``env.plain_step`` its eager version, called once each per
    step; on the CPU both are ``kernel_step``'s program."""
    import ppi_tpu_torch.envs.physics.rollout_kernel as rk
    calls = []
    real = rk.env_step

    def spy(env_, state_, action_, plain=False):
        calls.append(plain)
        return real(env_, state_, action_, plain)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rk, "env_step", spy)
        assert_kernel_step_is_the_eager_step(env, state, q, action)
    assert calls == [False, True]


def assert_objective_costs_match(env, state, acts, rew_ref):
    """``kernel_mpc_objective`` from ``state`` (all lanes at its posture)
    against the reference rewards, whole and with the last step masked."""
    from ppi_tpu_torch.envs.physics.rollout_kernel import kernel_mpc_objective
    h = acts.shape[1]
    mask = np.array([1.0] * (h - 1) + [0.0], np.float32)
    costs = kernel_mpc_objective(env, state, h)(None, to_torch(acts))
    masked = kernel_mpc_objective(env, state, h, to_torch(mask))(
        None, to_torch(acts))
    np.testing.assert_allclose(to_np(costs), -rew_ref.sum(1), **REW_TOL)
    np.testing.assert_allclose(to_np(masked), -(rew_ref * mask).sum(1),
                               **REW_TOL)


def assert_observe_and_success_match(jenv, env, state_cls, cases):
    """``cases``: (JAX state, expected success) pairs."""
    for jst, want in cases:
        st = port_state(state_cls, jst)
        np.testing.assert_allclose(to_np(env.observe(st)),
                                   np.asarray(jenv.observe(jst)), rtol=1e-5,
                                   atol=1e-6)
        assert bool(env.success(st)) == bool(jenv.success(jst)) == want


def run_on_cpu(argv, action_dim, timesteps=2, success_test=True,
               horizon=3):
    """The port's runner on the CPU at a tiny size; ``success_test``: the
    env has one (else the runner reports None)."""
    from ppi_tpu_torch.runners import run_mpc
    args = run_mpc.build_parser().parse_args(
        argv + ["--horizon", str(horizon), "--timesteps", str(timesteps),
                "--n-warmstart-iters", "1", "--device", "cpu", "MonteCarlo",
                "--n-samples", "6"])
    ret, success, track = run_mpc.main(args)
    assert np.isfinite(ret)
    assert success in (True, False) if success_test else success is None
    assert track["action"].shape == (timesteps, action_dim)
    assert bool(torch.isfinite(track["obs"]).all())


# ---- the hand door scenes (tests/test_torch_door_{hand,adroit}.py) --------

def hand_door_lanes(jenv, env, n: int, h: int):
    """(JAX reset state with a sampled frame, q0 (n,nq), qd0, actions
    (n,h,d_a), clamped lanes, free lanes). The first 3/8 of the lanes
    start from the reset posture; the rest with the door at 0.02 rad
    opening at 1 rad/s, the latch up in the clamped lanes (the bolt holds
    the door at its depth) and pressed to -1.0 in the free lanes. Actions:
    the initial posture plus 0.3 z."""
    js = jenv.reset(jax.random.key(0))
    door, latch = env.scalar_dyn_body, env._latch
    q0 = np.tile(np.asarray(js.physics.qpos), (n, 1))
    qd0 = np.zeros_like(q0)
    first, last = n * 3 // 8, n * 6 // 8
    q0[first:, door] = 0.02
    qd0[first:, door] = 1.0
    q0[last:, latch] = -1.0
    rng = np.random.default_rng(0)
    acts = (q0[:, None, :env.action_dim] + 0.3 * rng.standard_normal(
        (n, h, env.action_dim))).astype(np.float32)
    return js, q0, qd0, acts, np.arange(first, last), np.arange(last, n)


def _scalars(x):
    return tuple(torch.tensor(float(v)) for v in x)


def assert_hand_torque_matches(jenv, env):
    """``scalar_torque`` against the JAX env's, with targets inside and
    past the action box."""
    from ppi_tpu.envs.physics.engine_soa import SoaModel as JaxSoaModel
    from ppi_tpu_torch.envs.physics.engine_soa import SoaModel
    q = np.asarray(jenv.reset(jax.random.key(0)).physics.qpos) + 0.05
    qd = 0.1 * np.ones_like(q)
    act = np.linspace(-2.5, 2.5, env.action_dim).astype(np.float32)
    ref = jenv.scalar_torque(JaxSoaModel(jenv._model),
                             tuple(jnp.asarray(q)), tuple(jnp.asarray(qd)),
                             tuple(jnp.asarray(act)))
    got = env.scalar_torque(SoaModel(env._model), _scalars(q), _scalars(qd),
                            _scalars(act))
    np.testing.assert_allclose(np.array([float(v) for v in got]),
                               np.array([float(v) for v in ref]), rtol=1e-6,
                               atol=1e-6)


def assert_hand_projection_matches(jenv, env, case: str):
    """``scalar_project`` against the JAX env's ``scalar_project`` and
    ``_bolt_project`` on tests/test_door_hand.py's cases: the door swung to
    0.5 at 2 rad/s from closed with the latch up ("bolted": clamped to the
    bolt depth, velocity zeroed), with the latch pressed past the unlock
    angle ("unlatched") or from ajar ("ajar"): untouched."""
    door, latch = env.scalar_dyn_body, env._latch
    nq = env._model.nq
    q, qd, q_prev = np.zeros(nq, np.float32), np.zeros(nq, np.float32), \
        np.zeros(nq, np.float32)
    q[door], qd[door] = 0.5, 2.0
    if case == "unlatched":
        q[latch] = env.latch_unlock_angle - 0.1
    elif case == "ajar":
        q_prev[door] = 0.4
    qp_v, qv_v = jenv._bolt_project(jnp.asarray(q_prev[door]),
                                    jnp.asarray(q), jnp.asarray(qd))
    qp_s, qv_s = jenv.scalar_project(None, tuple(jnp.asarray(q_prev)),
                                     tuple(jnp.asarray(q)),
                                     tuple(jnp.asarray(qd)))
    qp, qv = env.scalar_project(None, _scalars(q_prev), _scalars(q),
                                _scalars(qd))
    qp = np.array([float(v) for v in qp], np.float32)
    qv = np.array([float(v) for v in qv], np.float32)
    for ref_q, ref_qd in ((qp_v, qv_v), (jnp.stack(qp_s), jnp.stack(qv_s))):
        np.testing.assert_array_equal(qp, np.asarray(ref_q))
        np.testing.assert_array_equal(qv, np.asarray(ref_qd))
    clamped = case == "bolted"
    assert qp[door] == (np.float32(env.bolt_depth) if clamped else 0.5)
    assert qv[door] == (0.0 if clamped else 2.0)


# ---- the variant-(b) envs of tests/test_torch_{reacher,finger,push,
# fetch_pick,locomotion}.py ---------------------------------------------------

# a reward entry this close to a threshold of its step function (a bonus
# radius, the healthy gate) may flip on one ulp of the state: such entries
# are masked and counted, not compared
THRESHOLD_BAND = 1e-5


def pinned_jax_state(js, qpos=None, **fields):
    """A JAX env state with its coordinates and other fields replaced."""
    if qpos is not None:
        js = js.replace(physics=js.physics.replace(
            qpos=jnp.asarray(qpos, jnp.float32)))
    return js.replace(**{k: jnp.asarray(v, jnp.float32)
                         for k, v in fields.items()})


def step_coordinates(env, state, acts):
    """The coordinates after each step of the port's eager step over N
    lanes from ``state``: (qpos (N,H,nq), qvel (N,H,nq)) as numpy."""
    from ppi_tpu_torch.envs.base import broadcast_state
    s = broadcast_state(state, acts.shape[0])
    qs, qds = [], []
    for t in range(acts.shape[1]):
        s, _ = env.plain_step(s, to_torch(acts[:, t]))
        qs.append(to_np(s.physics.qpos))
        qds.append(to_np(s.physics.qvel))
    return np.stack(qs, 1), np.stack(qds, 1)


def assert_rollout_close_off_thresholds(got, ref, margin,
                                        qd_tol=None) -> int:
    """``assert_rollout_close`` with the reward entries whose ``margin``
    (N, H), the distance of the quantity a step function reads to its
    threshold, is below THRESHOLD_BAND left out of the reward comparison;
    the velocities within ``qd_tol`` (REW_TOL unless given). Returns how
    many reward entries were left out."""
    near = np.asarray(margin) < THRESHOLD_BAND
    np.testing.assert_allclose(got[0][~near], ref[0][~near], **REW_TOL)
    np.testing.assert_allclose(got[1], ref[1], **Q_TOL)
    np.testing.assert_allclose(got[2], ref[2],
                               **(REW_TOL if qd_tol is None else qd_tol))
    return int(near.sum())


def assert_reward_clips_the_raw_action(env, state, acts, lim: float,
                                       uses_action: bool = True,
                                       plain=None):
    """The reward takes the raw action and clips it to +-``lim`` as the
    torque does: clipping the actions first changes nothing, while (for a
    reward with a control cost) a zero action changes the reward.
    ``plain``: the plain rollout of ``acts`` from ``state``, if at hand."""
    assert 0.1 < np.mean(np.abs(acts) > lim) < 0.9
    rew, qf, qdf = wrapper_run(env, state, acts) if plain is None else plain
    clipped = wrapper_run(env, state, np.clip(acts, -lim, lim))
    np.testing.assert_array_equal(rew, clipped[0])
    np.testing.assert_array_equal(qf, clipped[1])
    np.testing.assert_array_equal(qdf, clipped[2])
    n = acts.shape[0]
    q = state.physics.qpos.expand(n, -1).unbind(-1)
    qd = state.physics.qvel.expand(n, -1).unbind(-1)
    act = to_torch(acts[:, 0]).unbind(-1)
    r = env.scalar_reward(env._soa, q, qd, act)
    r0 = env.scalar_reward(env._soa, q, qd,
                           tuple(torch.zeros_like(a) for a in act))
    assert bool(torch.all(r0 != r)) == uses_action
    assert bool(torch.any(r0 != r)) == uses_action


def assert_uniform(samples, lo, hi):
    """Draws (n, k) of U(lo, hi) per column: inside the support, each
    column's mean within 4.5 standard errors of the midpoint, and its
    spread over more than 80% of the interval."""
    x = np.asarray(samples, np.float64)
    lo = np.broadcast_to(np.asarray(lo, np.float64), x.shape[1:])
    hi = np.broadcast_to(np.asarray(hi, np.float64), x.shape[1:])
    assert np.all(x >= lo - 1e-7) and np.all(x <= hi + 1e-7)
    se = (hi - lo) / np.sqrt(12.0 * x.shape[0])
    assert np.all(np.abs(x.mean(0) - 0.5 * (lo + hi)) < 4.5 * se)
    assert np.all(x.max(0) - x.min(0) > 0.8 * (hi - lo))


def resets(env, n: int = 400):
    """``n`` reset states of the port's env, one torch seed each."""
    return [env.reset(torch.Generator().manual_seed(k), "cpu")
            for k in range(n)]


def jax_pallas_rollout_fn(jenv):
    """The JAX package's own rollout kernel (``make_pallas_rollout``) in
    Pallas interpret mode: ``run(jax state, actions) -> (rewards, qf, qdf)``
    as numpy. The reference of the scalar program itself, argument order
    of the reward included; cheap only for the smallest bodies."""
    from ppi_tpu.envs.physics.pallas_rollout import (
        _pallas_operands, make_pallas_rollout)

    def rollout(jstate, acts):
        consts, dyn_body, dyn = _pallas_operands(jenv, jstate)
        n, h = acts.shape[0], acts.shape[1]
        fn = make_pallas_rollout(
            jenv._model, jenv.dt, jenv.substeps, h, jenv.action_dim,
            jenv.scalar_torque, jenv.scalar_reward,
            n_consts=0 if consts is None else int(consts.shape[0]),
            reward_takes_action=getattr(jenv, "scalar_reward_takes_action",
                                        False),
            dyn_body=dyn_body, block=8, interpret=True)
        q0 = jnp.broadcast_to(jstate.physics.qpos, (n,) +
                              jstate.physics.qpos.shape)
        qd0 = jnp.broadcast_to(jstate.physics.qvel, (n,) +
                               jstate.physics.qvel.shape)
        return fn(q0, qd0, acts, consts, dyn)

    fn = jax.jit(rollout)   # the state is traced: one compile per shape

    def run(jstate, acts):
        return tuple(np.asarray(x) for x in fn(jstate, jnp.asarray(acts)))

    return run
