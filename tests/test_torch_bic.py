"""Ball-in-a-cup's scalar program (``envs/ball_in_a_cup.py``) against the
JAX package's ``BallInCupSim`` on the same numpy inputs: the cup frame,
the body frames, the string's ``J^T F`` against ``jax.vjp``, one PBD step,
the reset, the score, and a short trajectory (a few steps of each phase)
with both couplings.

The JAX side runs its step under one ``jit`` per coupling in the phases
of ``BallInCupSim.execute_trajectory`` (its three scans would compile for
some 40 s), with strong types so that each compiles once (7-10 s cold).

Tolerances. The frames: 1e-6 absolute (a few float32 ulps of metre-scale
positions; torch's sin/cos differ from XLA's in the last bit for some
inputs). ``J^T F``: 1e-5 relative to the largest torque, since the JAX
package differentiates the frame's ops and the port sums the hinges'
columns. The trajectory: positions and the statistics to 1e-5 of
1 + |JAX|; the string's reaction, a second difference of the particles
over dt^2 = 4e-6 s^2, to 1e-3 N (a float32 ulp of a particle is ~1e-7 m);
the reward to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.ball_in_a_cup import BallInCupSim as JaxSim
from ppi_tpu.envs.physics.engine_soa import (
    make_body_frames_soa as jax_frames)
from ppi_tpu_torch.convert import bic_state_from_numpy
from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim, StateLayout
from ppi_tpu_torch.envs.physics.engine_soa import make_body_frames_soa

Q_START = np.array([0.0, 0.0, 0.0, 1.5707], np.float32)
N_STAB, T, N_COOL, LANES = 3, 5, 3, 3
TOL, REACTION_ATOL = 1e-5, 1e-3


def _poses(n, seed):
    return (Q_START + 0.4 * np.random.default_rng(seed).standard_normal(
        (n, 4))).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def test_frames_and_cup_frame_match_jax():
    sim, jsim = BallInCupSim(), JaxSim()
    q = _poses(5, 0)
    rot, pos = make_body_frames_soa(sim._model)(to_torch(q))
    jf = jax.vmap(jax_frames(jsim._model))
    jrot, jpos = jf(jnp.asarray(q))
    np.testing.assert_allclose(to_np(rot), np.asarray(jrot), atol=1e-6)
    np.testing.assert_allclose(to_np(pos), np.asarray(jpos), atol=1e-6)
    got = sim.cup_frame(to_torch(q))
    ref = jax.vmap(jsim.cup_frame)(jnp.asarray(q))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-6)


def test_jacobian_transpose_matches_vjp():
    """The hand-written ``J(q)^T F`` (a hinge's column ``axis_j x (anchor -
    origin_j)``) against ``jax.vjp`` of the JAX cup anchor, at five poses
    and forces up to the reaction's clip."""
    sim, jsim = BallInCupSim(), JaxSim()
    q = _poses(5, 1)
    f = (10.0 * np.random.default_rng(2).standard_normal((5, 3))).astype(
        np.float32)
    got = to_np(sim.anchor_jacobian_t(to_torch(q), to_torch(f)))

    def jt(qq, ff):
        return jax.vjp(lambda x: jsim.cup_frame(x)[0], qq)[1](ff)[0]

    ref = np.asarray(jax.jit(jax.vmap(jt))(jnp.asarray(q), jnp.asarray(f)))
    for k in range(5):
        assert np.max(np.abs(got[k] - ref[k])) <= TOL * np.max(np.abs(ref[k]))


@pytest.fixture(scope="module")
def string_case():
    """A string hanging from the reset pose and a ball pushed into the cup
    wall's band (so the contact branches act), stepped once from a
    perturbed previous position."""
    jsim = JaxSim()
    q = jnp.asarray(Q_START)
    s = jsim.reset(q)
    bottom, top, up = jsim.cup_frame(q)
    rng = np.random.default_rng(3)
    parts = np.asarray(s.particles).copy()
    parts[1:] += 0.01 * rng.standard_normal(parts[1:].shape)
    prev = parts + 0.002 * rng.standard_normal(parts.shape)
    prev[0] = parts[0]
    cases = []
    for ball in (parts[-1], np.asarray(bottom) + 0.03 * np.asarray(up)
                 + np.array([0.03, 0.0, 0.0]),
                 np.asarray(bottom) + 0.03 * np.asarray(up)
                 + np.array([0.045, 0.0, 0.0]),
                 np.asarray(bottom) - 0.01 * np.asarray(up)):
        p = parts.copy()
        p[-1] = ball
        cases.append((p.astype(np.float32), prev.astype(np.float32)))
    return cases


def test_one_pbd_step_matches_jax(string_case):
    """Verlet, the Jacobi sweeps and the cup's contact branches (the inner
    face, the outer face and just below the base), one step each."""
    sim, jsim = BallInCupSim(), JaxSim()
    q = jnp.asarray(Q_START)
    bottom, _, _ = jsim.cup_frame(q)
    step = jax.jit(jsim._pbd_step)
    for parts, prev in string_case:
        ref, ref_prev = step(jnp.asarray(parts), jnp.asarray(prev), bottom, q)
        got, got_prev = sim._pbd_step(to_torch(parts), to_torch(prev),
                                      to_torch(np.asarray(bottom)),
                                      to_torch(Q_START))
        np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)
        np.testing.assert_array_equal(to_np(got_prev), parts)


def test_reset_and_score_match_jax():
    sim, jsim = BallInCupSim(), JaxSim()
    s, js = sim.reset(to_torch(Q_START)), jsim.reset(jnp.asarray(Q_START))
    np.testing.assert_array_equal(to_np(s.particles), np.asarray(js.particles))
    assert float(s.max_pot_m) == -np.inf and not bool(s.violated)
    # the ball placed in the cup (success) and a violated state
    bottom, _, up = jsim.cup_frame(jnp.asarray(Q_START))
    parts = np.asarray(js.particles).copy()
    parts[-1] = np.asarray(bottom) + 0.03 * np.asarray(up)
    for viol in (False, True):
        jstate = js.replace(particles=jnp.asarray(parts),
                            max_pot_m=jnp.asarray(5.0),
                            n_steps=jnp.asarray(100.0),
                            sum_vel_pen=jnp.asarray(3.0),
                            sum_pos_pen=jnp.asarray(1.5),
                            violated=jnp.asarray(viol))
        state = bic_state_from_numpy(_fields(jstate), "cpu")
        r, ok = sim.reward_and_success(state)
        jr, jok = jsim.reward_and_success(jstate)
        np.testing.assert_allclose(float(r), float(jr), rtol=TOL)
        assert bool(ok) == bool(jok) == (not viol)


def _fields(js):
    return dict(qpos=np.asarray(js.arm.qpos), qvel=np.asarray(js.arm.qvel),
                particles=np.asarray(js.particles),
                particles_prev=np.asarray(js.particles_prev),
                string_force=np.asarray(js.string_force),
                max_pot_m=np.asarray(js.max_pot_m),
                sum_vel_pen=np.asarray(js.sum_vel_pen),
                sum_pos_pen=np.asarray(js.sum_pos_pen),
                sum_ball_vel_pen=np.asarray(js.sum_ball_vel_pen),
                n_steps=np.asarray(js.n_steps), q0=np.asarray(js.q0),
                violated=np.asarray(js.violated), t=np.asarray(js.t))


def _jax_execute(jsim, step, qs, qds):
    """``BallInCupSim.execute_trajectory``'s phases (ppi_tpu/envs/
    ball_in_a_cup.py:341-372) for a batch, with its ``step`` jitted once:
    stabilize, clear the statistics, the setpoints, cool down."""
    n = qs.shape[0]
    q0 = jnp.asarray(Q_START)
    # strong types throughout (the reset's ``max_pot_m`` is weakly typed),
    # so that ``step`` compiles once, not again after the first call
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x, x.dtype), (n,) + x.shape),
        jsim.reset(q0))
    hold, still = jnp.broadcast_to(q0, (n, 4)), jnp.zeros((n, 4))
    for _ in range(jsim.stabilize_steps):
        state = step(state, hold, still)
    state = state.replace(sum_vel_pen=jnp.zeros(n), sum_pos_pen=jnp.zeros(n),
                          sum_ball_vel_pen=jnp.zeros(n), n_steps=jnp.zeros(n),
                          max_pot_m=jnp.full(n, -jnp.inf, jnp.float32),
                          q0=state.arm.qpos)
    for k in range(qs.shape[1]):
        state = step(state, jnp.asarray(qs[:, k]), jnp.asarray(qds[:, k]))
    for _ in range(jsim.cooldown_steps):
        state = step(state, jnp.asarray(qs[:, -1]), still)
    assert step._cache_size() == 1
    return state


@pytest.mark.parametrize("same_step", [True, False])
def test_short_trajectory_matches_jax(same_step):
    """3 stabilize, 5 trajectory and 3 cool-down steps of three lanes whose
    setpoints swing the shoulder and the elbow, both couplings: the final
    state, the statistics, the reward and the success flag."""
    kw = dict(stabilize_steps=N_STAB, cooldown_steps=N_COOL,
              same_step_coupling=same_step)
    sim, jsim = BallInCupSim(**kw), JaxSim(**kw)
    rng = np.random.default_rng(4)
    qs = np.zeros((LANES, T, 4), np.float32)
    qds = np.zeros((LANES, T, 4), np.float32)
    qs[..., [1, 3]] = Q_START[[1, 3]] + 0.3 * rng.standard_normal(
        (LANES, T, 2))
    qds[..., [1, 3]] = 2.0 * rng.standard_normal((LANES, T, 2))
    step = jax.jit(jax.vmap(jsim.step))
    ref = _jax_execute(jsim, step, qs, qds)
    jr, jok = jax.jit(jax.vmap(jsim.reward_and_success))(ref)
    got = sim.execute_trajectory(to_torch(Q_START), to_torch(qs),
                                 to_torch(qds))
    r, ok = sim.reward_and_success(got)
    for a, b in ((got.arm.qpos, ref.arm.qpos), (got.arm.qvel, ref.arm.qvel),
                 (got.particles, ref.particles),
                 (got.particles_prev, ref.particles_prev),
                 (got.max_pot_m, ref.max_pot_m),
                 (got.sum_vel_pen, ref.sum_vel_pen),
                 (got.sum_pos_pen, ref.sum_pos_pen),
                 (got.sum_ball_vel_pen, ref.sum_ball_vel_pen),
                 (got.n_steps, ref.n_steps), (got.q0, ref.q0), (r, jr)):
        assert _rel(to_np(a), b) <= TOL
    np.testing.assert_allclose(to_np(got.string_force),
                               np.asarray(ref.string_force),
                               atol=REACTION_ATOL)
    np.testing.assert_array_equal(to_np(ok), np.asarray(jok))
    np.testing.assert_array_equal(to_np(got.violated),
                                  np.asarray(ref.violated))
    assert to_np(got.t).tolist() == [N_STAB + T + N_COOL] * LANES


def test_state_layout_round_trip():
    """The program's flat lane state and ``BicState`` convert both ways;
    the layout's offsets tile the state."""
    sim = BallInCupSim()
    L = sim.layout
    assert L == StateLayout(12) and L.size == 99 and L.str_size == 48
    s = sim.reset(to_torch(np.stack([Q_START, Q_START])))
    back = sim.state_of(sim.scalars(s), s.t)
    for a, b in ((back.particles, s.particles), (back.q0, s.q0),
                 (back.max_pot_m, s.max_pot_m)):
        assert torch.equal(a, b)
    assert sim._effective_pbd_iterations == 15
    assert BallInCupSim(n_particles=24)._effective_pbd_iterations == 60
    assert BallInCupSim(n_particles=6)._effective_pbd_iterations == 4
