"""The port's MJCF importer (``ppi_tpu_torch/envs/physics/mjcf.py``)
against ``ppi_tpu/envs/physics/mjcf.py``: an XML scene the test writes
(options, a joint default, quaternion and Euler frames, a two-joint body,
a welded body with a full inertia, diagonal inertias under a rotation,
geom-derived masses, a free body, sites and geoms), parsed by both, gives
equal finalized model arrays (bound: exact, both fold in float64 then
store float32) and equal joint, carrier, site and geom tables."""

import numpy as np
import pytest

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu.envs.physics import mjcf as jmjcf
from ppi_tpu_torch.envs.physics import mjcf
from ppi_tpu_torch.envs.physics.engine import MODEL_FIELDS

SCENE = """<mujoco model="test">
  <option timestep="0.0025" gravity="0 0 -9.7"/>
  <default><joint frictionloss="0.05" damping="0.3"/></default>
  <worldbody>
    <body name="arm" pos="0.1 0 1.0" quat="0.9659258 0 0 0.2588190">
      <inertial pos="0.01 0 0.02" mass="2.5"
                fullinertia="0.04 0.05 0.03 0.001 0.002 0.0005"/>
      <joint name="yaw" type="hinge" axis="0 0 1" limited="true"
             range="-2 2"/>
      <site name="shoulder" pos="0 0 0.05"/>
      <body name="upper" pos="0 0 0.3" euler="0.1 -0.2 0.3">
        <inertial pos="0 0 0.15" mass="1.2" diaginertia="0.01 0.02 0.005"
                  quat="0.7071068 0.7071068 0 0"/>
        <joint name="pitch" axis="0 1 0" pos="0 0 0.01"/>
        <joint name="roll" axis="1 0 0" pos="0 0 0.04" damping="1.5"/>
        <geom name="upper_geom" type="capsule" size="0.03 0.1"/>
        <body name="hand" pos="0 0 0.3">
          <inertial pos="0 0 0.02" mass="0.4"
                    fullinertia="0.002 0.002 0.001 0 0 0"/>
          <site name="palm" pos="0.01 0.02 0.05"/>
          <body name="ball" pos="0.05 0 0.1">
            <geom name="ball_geom" type="sphere" size="0.02" mass="0.03"
                  pos="0 0.01 0"/>
          </body>
        </body>
        <body name="slider" pos="0.1 0 0">
          <joint name="slide" type="slide" axis="0 0 1" limited="true"
                 range="-0.1 0.2" frictionloss="0"/>
          <geom type="sphere" size="0.01" mass="0.2"/>
        </body>
      </body>
    </body>
    <body name="puck" pos="0.5 0.2 0.1">
      <freejoint name="puck_free"/>
      <geom name="puck_geom" type="sphere" size="0.04" mass="0.1"/>
      <body name="flap" pos="0 0 0.05">
        <joint name="flap" axis="0 1 0"/>
        <geom type="sphere" size="0.01" mass="0.01"/>
      </body>
    </body>
    <body name="ghost" pos="1 1 1">
      <freejoint/>
      <geom type="sphere" size="0.05" mass="0.2"/>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = tmp_path_factory.mktemp("mjcf") / "scene.xml"
    path.write_text(SCENE)
    return path


@pytest.mark.parametrize("kw", [
    {}, {"root_bodies": ["arm"]},
    {"spec": {"limit_k": 50.0, "armature": 0.02},
     "joint_overrides": {"pitch": {"armature": 0.1, "damping": 2.0}}}],
    ids=["default", "root_bodies", "spec_overrides"])
def test_finalized_models_equal(scene, kw):
    def load(mod):
        k = dict(kw)
        if "spec" in k:
            k["spec"] = mod.MjcfJointSpec(**k["spec"])
        return mod.load_mjcf(str(scene), **k)

    want, got = load(jmjcf), load(mjcf)
    wm, gm = want.builder.finalize(), got.builder.finalize()
    for name in MODEL_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(gm, name)),
                                      np.asarray(getattr(wm, name)), name)
    assert gm.parents == tuple(wm.parents)
    assert gm.joint_types == tuple(wm.joint_types)
    assert got.timestep == want.timestep
    np.testing.assert_array_equal(got.gravity, want.gravity)
    assert got.joint_id == want.joint_id
    assert got.body_carrier == want.body_carrier
    for name in want.body_pos:
        np.testing.assert_array_equal(got.body_pos[name],
                                      want.body_pos[name])
        np.testing.assert_array_equal(got.body_rot[name],
                                      want.body_rot[name])
    assert got.sites.keys() == want.sites.keys()
    for name, (carrier, pos) in want.sites.items():
        assert got.site_local(name)[0] == carrier
        np.testing.assert_array_equal(got.site_local(name)[1], pos)
    assert len(got.geoms) == len(want.geoms)
    for g, w in zip(got.geoms, want.geoms):
        assert (g.name, g.type, g.body, g.body_name) == \
            (w.name, w.type, w.body, w.body_name)
        for field in ("pos", "rot", "size"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))


def test_import_shape(scene):
    """What the scene maps to: 3 + 1 + 6 + 1 bodies (the ghost free body,
    with no joint below it, is skipped), the welded hand's and ball's mass
    folded into the roll joint's body, gravity onto the builder."""
    m = mjcf.load_mjcf(str(scene))
    assert len(m.builder._bodies) == 11
    roll = m.builder._bodies[m.joint_id["roll"]]
    assert roll["mass"] == pytest.approx(1.2 + 0.4 + 0.03 + 1e-6, rel=1e-6)
    assert m.builder.gravity == (0.0, 0.0, -9.7)
    assert "ghost" not in m.body_carrier
