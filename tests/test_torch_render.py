"""The port's schematic renders (``ppi_tpu_torch/render.py``) against
``ppi_tpu/render.py`` on the same 3-frame qpos histories, the batched FK
of a history against per-frame FK, and ``trace_bic_trajectory`` against
JAX's trace of the same setpoints.

Bounds: the rasterised frames differ by at most 1 level of 255 anywhere
(the same matplotlib draws data that differ in the last bits of f32);
batched and per-frame FK 1e-6; the traced history (qpos, particles) 1e-5
of JAX's (the port steps in f32 on the host, JAX's XLA on the CPU), and
its final state equals the plain ``execute_trajectory``'s to 1e-5 of
1 + |plain|, the success flag exactly.
"""

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu import render as jrender
from ppi_tpu_torch import render

FRAME_TOL = 1      # levels of 255


def _history(q0, scale, n=3, seed=0):
    rng = np.random.default_rng(seed)
    q0 = np.asarray(q0, np.float32)
    return (q0 + scale * rng.standard_normal((n, q0.shape[0]))).astype(
        np.float32)


def _compare(jpath, path):
    want = np.stack(imageio.mimread(jpath))
    got = np.stack(imageio.mimread(path))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= FRAME_TOL


def test_render_door_frames_equal_jax(tmp_path):
    from ppi_tpu.envs.door import Door as JDoor
    from ppi_tpu_torch.envs.door import Door
    q = _history([0.0, 0.6, -0.8, 0.2, 0.3, -0.2], 0.2)
    frame = np.array([0.56, 0.33, 1.02], np.float32)
    jpath = jrender.render_door(JDoor(), q, tmp_path / "j.gif", stride=1,
                                frame=frame)
    path = render.render_door(Door(), torch.from_numpy(q), tmp_path / "t.gif",
                              stride=1, frame=torch.from_numpy(frame))
    _compare(jpath, path)
    assert len(imageio.mimread(path)) == 3


def test_render_door_hand_frames_equal_jax(tmp_path):
    from ppi_tpu.envs.door_hand import DoorHand as JDoorHand
    from ppi_tpu_torch.envs.door_hand import DoorHand
    env = DoorHand()
    q = _history(np.zeros(env._model.nq), 0.3)
    jpath = jrender.render_door_hand(JDoorHand(engine="tensor"), q,
                                     tmp_path / "j.gif", stride=1)
    path = render.render_door_hand(env, q, tmp_path / "t.gif", stride=1,
                                   device="cpu")
    _compare(jpath, path)


def test_render_planar_frames_equal_jax(tmp_path):
    from ppi_tpu.envs.cheetah import Cheetah as JCheetah
    from ppi_tpu_torch.envs.cheetah import Cheetah
    env = Cheetah()
    q = _history(np.zeros(env._model.nq), 0.3, seed=1)
    jpath = jrender.render_planar(JCheetah(), q, tmp_path / "j.gif",
                                  stride=1)
    path = render.render_planar(env, q, tmp_path / "t.gif", stride=1,
                                device="cpu")
    _compare(jpath, path)


def test_avi_output_decodes_with_every_frame(tmp_path):
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.utils.video import read_avi_frames
    q = _history([0.0, 0.6, -0.8, 0.2, 0.0, 0.0], 0.2, n=5)
    path = render.render_door(Door(), q, tmp_path / "e.avi", stride=2,
                              device="cpu")
    frames = read_avi_frames(path)
    assert len(frames) == 3 and frames[0].shape == (500, 500, 3)


@pytest.mark.parametrize("env_name", ["door-v0", "door-v0-hand",
                                      "hammer-v0-hand"])
def test_history_fk_equals_per_frame_fk(env_name):
    """One call over the T frames as lanes gives each frame's FK."""
    from ppi_tpu_torch.runners.run_mpc import ENVS
    env = ENVS[env_name]()
    q = torch.from_numpy(_history(np.zeros(env._model.nq), 0.4, n=4))
    body = env.scalar_dyn_body
    pos3 = torch.tensor([0.5, 0.3, 1.0])
    rot, pos = render.body_frames(env._model, q, body, pos3)
    for t in range(4):
        r1, p1 = render.body_frames(env._model, q[t:t + 1], body, pos3)
        np.testing.assert_allclose(rot[t], r1[0], atol=1e-6)
        np.testing.assert_allclose(pos[t], p1[0], atol=1e-6)


def test_trace_bic_trajectory_matches_jax_history():
    """JAX's ``trace_bic_trajectory`` loop (reset, stabilize, trajectory,
    cool-down; (qpos, particles) recorded after each step of the last two)
    over a jitted ``sim.step``: one compile where the trace's three scans
    compile the step three times."""
    from ppi_tpu.envs.ball_in_a_cup import BallInCupSim as JSim
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    kw = dict(stabilize_steps=3, cooldown_steps=4, n_particles=6)
    rng = np.random.default_rng(0)
    q0 = np.array([0.0, 0.0, 0.0, 1.5707], np.float32)
    qs = (q0 + 0.3 * rng.standard_normal((6, 4))).astype(np.float32)
    qds = (0.5 * rng.standard_normal((6, 4))).astype(np.float32)

    jsim = JSim(**kw)
    step = jax.jit(jsim.step)
    # strong types throughout (the reset's ``max_pot_m`` is weakly typed),
    # so that ``step`` compiles once
    s = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                               jsim.reset(jnp.asarray(q0)))
    for _ in range(jsim.stabilize_steps):
        s = step(s, jnp.asarray(q0), jnp.zeros(4))
    setpoints = [(qs[k], qds[k]) for k in range(6)]
    setpoints += [(qs[-1], np.zeros(4, np.float32))] * jsim.cooldown_steps
    jq, jp = [], []
    for a, b in setpoints:
        s = step(s, jnp.asarray(a), jnp.asarray(b))
        jq.append(np.asarray(s.arm.qpos))
        jp.append(np.asarray(s.particles))

    sim = BallInCupSim(**kw)
    qh, ph, final = render.trace_bic_trajectory(
        sim, torch.from_numpy(q0), torch.from_numpy(qs),
        torch.from_numpy(qds))
    assert qh.shape == (10, 4) and ph.shape == (10, 7, 3)
    np.testing.assert_allclose(qh.numpy(), np.stack(jq), atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.stack(jp), atol=1e-5)

    plain = sim.execute_trajectory(torch.from_numpy(q0),
                                   torch.from_numpy(qs)[None],
                                   torch.from_numpy(qds)[None])
    a = torch.stack(sim.scalars(final), -1)
    b = torch.stack(sim.scalars(plain), -1)[0]
    finite = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), finite)
    assert bool(((a - b).abs()[finite] <= 1e-5 * (1 + b.abs()[finite]))
                .all())
    assert int(final.t) == int(plain.t[0])
    assert bool(sim.reward_and_success(final)[1]) == bool(
        sim.reward_and_success(plain)[1][0])


def test_render_ball_in_a_cup_writes_the_traced_frames(tmp_path):
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    sim = BallInCupSim(stabilize_steps=2, cooldown_steps=3)
    q0 = torch.tensor([0.0, 0.0, 0.0, 1.5707])
    qs = q0.repeat(5, 1)
    qh, ph, _ = render.trace_bic_trajectory(sim, q0, qs, torch.zeros(5, 4))
    path = render.render_ball_in_a_cup(sim, qh, ph, tmp_path / "b.gif",
                                       stride=4)
    assert len(imageio.mimread(path)) == 2
