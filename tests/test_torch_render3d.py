"""The port's analytic ray-caster (``ppi_tpu_torch/render3d.py``): the JAX
package's nine property checks (``tests/test_render3d.py``) on the port's
two-body scene, then its frames against ``ppi_tpu/render3d.py``'s on the
same qpos at 48x48, for that scene and for door-v0 with a ``dyn_pos``.

Bound of the comparison: at most 0.5% of pixels (on silhouettes and
shadow edges, where a last-bit difference in the FK moves a hit) differ
by more than 1 level of 255; measured on the CPU: none, and under 0.05%
by exactly 1.
"""

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu import render3d as jrender3d
from ppi_tpu.envs.physics import ModelBuilder as JaxModelBuilder
from ppi_tpu_torch import render3d
from ppi_tpu_torch.envs.physics import HINGE, ModelBuilder

OFF_BY_MORE_THAN_1 = 0.005


class _TinyEnv:
    """Minimal env surface for render_trajectory: just `_model`."""

    def __init__(self, model):
        self._model = model


def _scene(with_plane=True, second_sphere=None, builder=ModelBuilder):
    b = builder()
    b.add_body(parent=-1, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0, 0, 1.0), mass=1.0)
    b.add_body(parent=0, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0.4, 0, 0), mass=1.0)
    s0 = b.add_sphere(0, (0, 0, 0), 0.15)
    b.add_sphere(1, (0, 0, 0), 0.10)
    if second_sphere is not None:
        b.add_sphere(0, second_sphere, 0.15)
    if with_plane:
        b.add_plane(normal=(0, 0, 1), offset=0.0)
    return _TinyEnv(b.finalize()), s0


def _cam(eye=(0.0, -2.0, 1.0), target=(0.0, 0.0, 1.0), n=96, mod=render3d):
    return mod.Camera(eye=eye, target=target, width=n, height=n)


def _render(env, traj, **kw):
    return render3d.render_trajectory(env, torch.as_tensor(traj), **kw)


def test_frames_shape_dtype_and_stride():
    env, _ = _scene()
    frames = _render(env, torch.zeros((6, 2)), camera=_cam(n=48), stride=2)
    assert frames.shape == (3, 48, 48, 3)
    assert frames.dtype == np.uint8


def test_center_pixel_hits_root_sphere_with_its_color():
    style = render3d.SceneStyle(sphere_colors={0: (1.0, 0.0, 0.0)},
                                ambient=1.0)  # flat shading: pure albedo
    env, s0 = _scene()
    frames = _render(env, torch.zeros((1, 2)), camera=_cam(), style=style)
    c = frames[0, 48, 48]  # camera looks straight at body 0's sphere
    assert c[0] > 200 and c[1] < 80 and c[2] < 80


def test_depth_ordering_front_sphere_occludes():
    """A second sphere on the camera side of the root must win the z-test."""
    style = render3d.SceneStyle(sphere_colors={0: (1, 0, 0), 2: (0, 0, 1)},
                                ambient=1.0)
    env, _ = _scene(second_sphere=(0, -0.5, 0))  # toward the camera
    frames = _render(env, torch.zeros((1, 2)), camera=_cam(), style=style)
    c = frames[0, 48, 48]
    assert c[2] > 200 and c[0] < 80  # blue (near), not red (far)


def test_ground_checker_two_tones_and_background():
    env, _ = _scene()
    cam = _cam(eye=(0.6, -2.0, 1.2), target=(0.0, 0.0, 0.6))
    frames = _render(env, torch.zeros((1, 2)), camera=cam)
    img = frames[0].astype(np.int32)
    bottom = img[-12:, :, 0].ravel()       # ground rows
    assert len(np.unique(bottom)) >= 2     # checker: at least two tones
    bg = render3d.SceneStyle().background
    top = img[:4, :4]                      # sky rows
    assert np.all(np.abs(top - np.round(np.array(bg) * 255)) <= 2)


def test_link_capsule_visible_between_bodies():
    """Pixels between the two joint origins hit the link capsule (without
    it, rays there would reach the background)."""
    env, _ = _scene(with_plane=False)
    style = render3d.SceneStyle(link_radius=0.05, ambient=1.0)
    cam = _cam(eye=(0.2, -2.0, 1.0), target=(0.2, 0.0, 1.0))
    frames = _render(env, torch.zeros((1, 2)), camera=cam, style=style)
    mid = frames[0, 48, 48].astype(np.float32) / 255.0
    np.testing.assert_allclose(mid, [0.62, 0.64, 0.68], atol=0.03)


def test_articulated_motion_moves_pixels():
    env, _ = _scene()
    traj = torch.tensor([[0.0, 0.0], [1.2, 0.8]])
    frames = _render(env, traj, camera=_cam())
    assert np.mean(frames[0] != frames[1]) > 0.005


def test_shadow_darkens_ground():
    """The root sphere must cast a hard shadow: with shadows the lit-ground
    brightness range widens vs ambient-only shading."""
    env, _ = _scene()
    cam = _cam(eye=(0.0, -1.6, 1.8), target=(0.0, 0.3, 0.4))
    lit = _render(env, torch.zeros((1, 2)), camera=cam,
                  style=render3d.SceneStyle(light_dir=(0.0, 0.0, 1.0)))
    flat = _render(env, torch.zeros((1, 2)), camera=cam,
                   style=render3d.SceneStyle(light_dir=(0.0, 0.0, 1.0),
                                             ambient=1.0))
    ground_lit = lit[0, -30:, :, 0].astype(np.float32)
    ground_flat = flat[0, -30:, :, 0].astype(np.float32)
    assert ground_lit.min() < ground_flat.min() - 20


def test_dyn_body_offset_shifts_geometry():
    """dyn_pos substitutes the dynamic body's offset like make_sites_soa."""
    env, _ = _scene(with_plane=False)
    env.scalar_dyn_body = 1
    style = render3d.SceneStyle(ambient=1.0)
    cam = _cam()
    a = _render(env, torch.zeros((1, 2)), camera=cam, style=style,
                dyn_pos=(0.4, 0.0, 0.0))
    b = _render(env, torch.zeros((1, 2)), camera=cam, style=style,
                dyn_pos=(-0.4, 0.4, 0.2))
    assert np.mean(a != b) > 0.002


def test_save_gif_3d_writes_file(tmp_path):
    env, _ = _scene()
    out = render3d.save_gif_3d(tmp_path / "scene.gif", env,
                               torch.zeros((2, 2)), camera=_cam(n=32))
    assert out.exists() and out.stat().st_size > 200


def _off(got, want):
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    return float((d > 1).mean())


def test_two_body_scene_frames_match_jax():
    traj = np.array([[0.0, 0.0], [1.2, 0.8], [0.3, -0.5]], np.float32)
    eye, target = (0.6, -2.0, 1.2), (0.0, 0.0, 0.6)
    want = jrender3d.render_trajectory(
        _scene(builder=JaxModelBuilder)[0], traj,
        camera=_cam(eye, target, 48, jrender3d))
    got = render3d.render_trajectory(_scene()[0], traj,
                                     camera=_cam(eye, target, 48),
                                     device="cpu")
    assert got.shape == want.shape == (3, 48, 48, 3)
    assert _off(got, want) <= OFF_BY_MORE_THAN_1


def test_door_frames_with_dyn_pos_match_jax():
    from ppi_tpu.envs.door import Door as JDoor
    from ppi_tpu_torch.envs.door import Door
    rng = np.random.default_rng(0)
    q = (np.array([0.0, 0.6, -0.8, 0.2, 0.0, 0.0], np.float32)
         + 0.3 * rng.standard_normal((3, 6))).astype(np.float32)
    frame = np.array([0.56, 0.34, 1.02], np.float32)
    want = jrender3d.render_trajectory(
        JDoor(), q, camera=jrender3d.Camera(width=48, height=48),
        style=jrender3d.SceneStyle(floor=0.0), dyn_pos=frame)
    got = render3d.render_trajectory(
        Door(), q, camera=render3d.Camera(width=48, height=48),
        style=render3d.SceneStyle(floor=0.0), dyn_pos=frame, device="cpu")
    assert _off(got, want) <= OFF_BY_MORE_THAN_1


@pytest.mark.parametrize("budget", [1, 800_000])
def test_chunked_frames_equal_one_chunk(budget, monkeypatch):
    """A small memory budget renders one or two frames a chunk, to the
    same bits."""
    env, _ = _scene()
    traj = torch.tensor([[0.0, 0.0], [1.2, 0.8], [0.3, -0.5]])
    one = _render(env, traj, camera=_cam(n=32))
    monkeypatch.setattr(render3d, "MEMORY_BUDGET", budget)
    assert render3d.frames_per_chunk(env._model, _cam(n=32), np.zeros(
        (1, 2))) < 3
    np.testing.assert_array_equal(_render(env, traj, camera=_cam(n=32)),
                                  one)


def test_matmul_precision_setting_changes_nothing():
    """No dot product of the renderer is a matmul: the frames are the same
    bits whatever ``torch.set_float32_matmul_precision`` says."""
    env, _ = _scene()
    traj = torch.tensor([[0.3, 0.2], [1.0, -0.4]])
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        a = _render(env, traj, camera=_cam(n=32))
        torch.set_float32_matmul_precision("medium")
        b = _render(env, traj, camera=_cam(n=32))
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(a, b)
