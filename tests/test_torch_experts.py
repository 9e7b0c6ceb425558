"""The scripted experts' pieces against the JAX package.

Whole experts run thousands of control steps (each step of the plain
program takes 0.2-1.5 s on a CPU at these scenes' widths), so they run on
the card only (``chip_smoke.py`` phase 46); here each piece meets its JAX
counterpart on the same numbers:

* pen-v0-hand's closed-form digit IK, its FK, the digit command and the
  scripted controller, on numpy-seeded inputs (to 1e-5: a few f32 ops of
  trigonometry, the same formulas), and ``scripted_reorient(steps=3)``:
  the port's plain step against JAX's ``engine="tensor"`` env at the
  door-hand tests' tolerances (``torch_env_helpers.REW_TOL``, ``Q_TOL``);
* hammer-v0-adroit's power-wrap command, exactly;
* each expert's plain palm IK (``_ik``, ``_ik_palm``: ``torch.autograd``
  through ``_sites_soa``) at 3 iterations from its first call's kind of
  inputs against JAX's ``jax.grad`` loop (under ``jax.jit``: its compile,
  ~4-8 s a scene, costs less than its eager run), to 1e-5;
* the key(0) scene constants of ``convert`` against JAX's draws,
  exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_env_helpers import Q_TOL, REW_TOL, port_state
from torch_helpers import to_np
import ppi_tpu.envs.door_adroit as jax_door_adroit
import ppi_tpu.envs.door_hand as jax_door_hand
import ppi_tpu.envs.hammer_adroit as jax_hammer_adroit
import ppi_tpu.envs.hammer_hand as jax_hammer_hand
import ppi_tpu.envs.pen_hand as jax_pen_hand
import ppi_tpu.envs.relocate_adroit as jax_relocate_adroit
import ppi_tpu.envs.relocate_hand as jax_relocate_hand
from ppi_tpu_torch import convert
from ppi_tpu_torch.envs import (
    door_adroit, door_hand, hammer_adroit, hammer_hand, pen_hand,
    relocate_adroit, relocate_hand)

TOL = dict(rtol=1e-5, atol=1e-5)
IK_TOL = dict(rtol=0, atol=1e-5)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


# ---- pen-v0-hand ---------------------------------------------------------------

def test_pen_digit_ik_and_fk_match_reference():
    rng = np.random.default_rng(0)
    ty = rng.uniform(-0.12, 0.12, 64).astype(np.float32)
    tz = rng.uniform(0.8, 1.05, 64).astype(np.float32)
    got = pen_hand._ik_up(_t(ty), _t(tz))
    ref = jax_pen_hand._ik_up(jnp.asarray(ty), jnp.asarray(tz))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(to_np(g), np.asarray(r), **TOL)
    a, b = (rng.uniform(-1.3, 1.3, 64).astype(np.float32) for _ in range(2))
    for g, r in zip(pen_hand._fk_up(_t(a), _t(b)),
                    jax_pen_hand._fk_up(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(to_np(g), np.asarray(r), **TOL)
    # the tip reached through the IK is the clipped target
    y, z = pen_hand._fk_up(*got)
    assert bool(torch.isfinite(y).all() and torch.isfinite(z).all())


@pytest.mark.parametrize("case", range(12))
def test_pen_digit_command_matches_reference(case):
    """Cases 0-3 press from a small ``d`` (the standoff branch), the
    others from the right or the wrong side of the rod."""
    rng = np.random.default_rng(100 + case)
    q = rng.uniform(-0.8, 0.8, 2).astype(np.float32)
    rod = np.array([rng.uniform(-0.04, 0.04), rng.uniform(0.95, 1.0)],
                   np.float32)
    scale = 0.001 if case < 4 else 0.02
    d = (scale * rng.standard_normal(2)).astype(np.float32)
    got = pen_hand._digit_cmd(_t(q), _t(rod), _t(d))
    ref = jax_pen_hand._digit_cmd(jnp.asarray(q), jnp.asarray(rod),
                                  jnp.asarray(d))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def jpen():
    return jax_pen_hand.PenHand(engine="tensor", fixed_goal=True)


def test_pen_scripted_controller_matches_reference(jpen):
    env = pen_hand.PenHand(fixed_goal=True)
    js = jpen.reset(jax.random.key(0))
    rng = np.random.default_rng(7)
    goal = np.asarray(js.target_axis)
    ctrl = pen_hand.scripted_controller(env, _t(goal))
    jctrl = jax_pen_hand.scripted_controller(jpen, jnp.asarray(goal))
    for _ in range(6):
        qpos = np.asarray(js.physics.qpos).copy()
        qpos[:5] += (0.05 * rng.standard_normal(5)).astype(np.float32)
        qpos[5:] += (0.3 * rng.standard_normal(6)).astype(np.float32)
        jst = js.replace(physics=js.physics.replace(qpos=jnp.asarray(qpos)))
        st = port_state(pen_hand.PenHandState, jst)
        np.testing.assert_allclose(to_np(ctrl(st)), np.asarray(jctrl(jst)),
                                   **TOL)


def test_pen_scripted_reorient_matches_reference(jpen):
    env = pen_hand.PenHand(fixed_goal=True)
    js = jpen.reset(jax.random.key(0))
    jsf, jinfo = jax_pen_hand.scripted_reorient(jpen, js, steps=3)
    sf, info = pen_hand.scripted_reorient(
        env, port_state(pen_hand.PenHandState, js), steps=3, device="cpu")
    np.testing.assert_allclose(to_np(info["similarity"]),
                               np.asarray(jinfo["similarity"]), **REW_TOL)
    np.testing.assert_allclose(to_np(sf.physics.qpos),
                               np.asarray(jsf.physics.qpos), **Q_TOL)
    np.testing.assert_allclose(to_np(sf.physics.qvel),
                               np.asarray(jsf.physics.qvel), **REW_TOL)
    assert info["dropped"] == jinfo["dropped"] is False
    assert info["max_similarity"] == pytest.approx(jinfo["max_similarity"],
                                                   abs=1e-5)
    assert info["final_similarity"] == pytest.approx(
        jinfo["final_similarity"], abs=1e-5)
    assert int(sf.t) == 3


# ---- constants and commands ------------------------------------------------------

def test_expert_constants_match_reference():
    assert relocate_hand.CARRY_POSES == jax_relocate_hand.CARRY_POSES
    assert relocate_hand.GRIP_FINGER == jax_relocate_hand.GRIP_FINGER
    assert relocate_hand.GRIP_THUMB == jax_relocate_hand.GRIP_THUMB
    assert relocate_adroit.GRIP_FINGER == jax_relocate_adroit.GRIP_FINGER
    assert relocate_adroit.GRIP_THUMB == jax_relocate_adroit.GRIP_THUMB
    np.testing.assert_array_equal(
        np.asarray(door_adroit._CURL_CLEAR, np.float32),
        np.asarray(jax_door_adroit._CURL_CLEAR))


@pytest.mark.parametrize("mcp,pip", [(0.5, 0.9), (0.9, 1.9), (0.7, None)])
def test_hammer_adroit_grip_matches_reference(mcp, pip):
    cmd = np.random.default_rng(3).uniform(-1, 1, 21).astype(np.float32)
    got = hammer_adroit._grip(_t(cmd), mcp, pip)
    ref = jax_hammer_adroit._grip(jnp.asarray(cmd), mcp, pip)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    assert torch.equal(_t(cmd), _t(cmd))  # the input is not written


@pytest.mark.parametrize("jax_cls,attr,const", [
    (jax_door_hand.DoorHand, "frame", convert.KEY0_DOOR_FRAME),
    (jax_door_adroit.DoorAdroit, "frame", convert.KEY0_DOOR_FRAME),
    (jax_hammer_hand.HammerHand, "board", convert.KEY0_HAMMER_BOARD),
    (jax_hammer_adroit.HammerAdroit, "board", convert.KEY0_HAMMER_BOARD)])
def test_key0_scene_constants_are_jax_draws(jax_cls, attr, const):
    drawn = getattr(jax_cls(engine="tensor").reset(jax.random.key(0)), attr)
    np.testing.assert_array_equal(np.asarray(const, np.float32),
                                  np.asarray(drawn))


def test_key0_scenes_pin_the_port_reset():
    s = door_hand.DoorHand().reset(None, "cpu",
                                   frame=convert.KEY0_DOOR_FRAME)
    np.testing.assert_array_equal(to_np(s.frame),
                                  np.asarray(convert.KEY0_DOOR_FRAME,
                                             np.float32))
    s = hammer_hand.HammerHand().reset(None, "cpu",
                                       board=convert.KEY0_HAMMER_BOARD)
    assert float(s.board[2]) > 0.73   # the raised-board regime


# ---- the plain palm IK against JAX's ----------------------------------------------

def _door_case(jmod, mod, jcls, cls, kw):
    jenv, env = jcls(engine="tensor", **kw), cls(**kw)
    js = jenv.reset(jax.random.key(0))
    pts = jenv._sites_soa(js.physics.qpos, js.frame)
    handle = 0.5 * (pts[jenv._handle_geoms[0]] + pts[jenv._handle_geoms[1]])
    target = handle + jnp.array([0.0, 0.0, 0.075])
    q_init = js.physics.qpos[:env.action_dim]
    ref = jmod._ik(jenv, js, target, q_init, iters=3)
    got = mod._ik(env, port_state(door_hand.DoorHandState, js),
                  _t(target), _t(q_init), iters=3)
    return got, ref


def _hammer_case(jmod, mod, jcls, cls, level_weight):
    jenv, env = jcls(engine="tensor"), cls()
    js = jenv.reset(jax.random.key(0))
    n = env.action_dim
    rng = np.random.default_rng(5)
    q_init = np.asarray(js.physics.qpos[:n]) + (
        0.1 * rng.standard_normal(n)).astype(np.float32)
    q_init = np.clip(q_init, np.asarray(env._low), np.asarray(env._high))
    target = js.board + jnp.asarray([-0.18, 0.0, 0.32])
    ref = jmod._ik_palm(jenv, js, target, jnp.asarray(q_init), iters=3,
                        level_weight=level_weight)
    got = mod._ik_palm(env, port_state(hammer_hand.HammerHandState, js),
                       _t(target), _t(q_init), iters=3,
                       level_weight=level_weight)
    return got, ref


def _relocate_case():
    jenv = jax_relocate_adroit.RelocateAdroit(engine="tensor",
                                              fixed_goal=True)
    env = relocate_adroit.RelocateAdroit(fixed_goal=True)
    js = jenv.reset(jax.random.key(0))
    grip = js.physics.qpos[:21].at[6:].set(jnp.array(
        jax_relocate_adroit.GRIP_FINGER * 4 + jax_relocate_adroit.GRIP_THUMB))
    target = jnp.asarray([0.58, 0.0, 0.74])
    ref = jax_relocate_adroit._ik_palm(jenv, js, target, js.physics.qpos[:4],
                                       grip[6:], iters=3, lr=0.05)
    got = relocate_adroit._ik_palm(
        env, port_state(relocate_hand.RelocateHandState, js), _t(target),
        _t(js.physics.qpos[:4]), _t(grip[6:]), iters=3, lr=0.05)
    return got, ref


IK_CASES = {
    "door-v0-hand": lambda: _door_case(
        jax_door_hand, door_hand, jax_door_hand.DoorHand,
        door_hand.DoorHand, {}),
    "door-v0-adroit": lambda: _door_case(
        jax_door_adroit, door_adroit, jax_door_adroit.DoorAdroit,
        door_adroit.DoorAdroit, {"fixed_scene": True}),
    "hammer-v0-hand": lambda: _hammer_case(
        jax_hammer_hand, hammer_hand, jax_hammer_hand.HammerHand,
        hammer_hand.HammerHand, 0.05),
    "hammer-v0-adroit": lambda: _hammer_case(
        jax_hammer_adroit, hammer_adroit, jax_hammer_adroit.HammerAdroit,
        hammer_adroit.HammerAdroit, 0.005),
    "relocate-v0-adroit": _relocate_case,
}


@pytest.mark.parametrize("name", list(IK_CASES))
def test_plain_palm_ik_matches_reference(name):
    got, ref = IK_CASES[name]()
    np.testing.assert_allclose(to_np(got), np.asarray(ref), **IK_TOL)
    assert got.shape == ref.shape
