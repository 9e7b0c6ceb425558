"""MJCF importer: scene parameters from MuJoCo XML into ``ModelBuilder``.

Port of ``ppi_tpu/envs/physics/mjcf.py`` (numpy over the builder; the
port's ``ModelBuilder`` keeps the JAX builder's body records, so the
importer is the same walk). It parses an MJCF body tree (masses,
inertias, joint axes, anchors, ranges, damping and friction loss, site
positions) into the one-DoF-per-body builder chain the engine consumes.

Mapping rules (MJCF -> builder):

* **jointed body** with k joints -> k chained builder bodies. The first
  carries the fixed parent-frame transform (body ``pos``/``quat``/``euler``
  composed with the joint anchor); joints 2..k are zero-offset children
  anchored at their own ``pos``. The LAST body in the chain carries the
  mass/inertia/com (intermediates are near-massless proxies), matching
  MuJoCo's composition of stacked joint DoFs in declaration order.
* **jointless body** -> welded: its mass/inertia are merged into the
  nearest jointed ancestor's builder body by the parallel-axis theorem
  (what the MuJoCo compiler does for fuse-able static bodies), and its
  frame is recorded so sites/geoms declared under it resolve to
  carrier-local coordinates.
* **freejoint** -> a 3-slide + 3-hinge chain (the engine's free-body
  idiom).
* **inertial** ``fullinertia``/``diaginertia``+``quat`` are rotated into
  the body frame about the com; a body without ``<inertial>`` derives mass
  from its geoms (explicit ``mass`` attributes; sphere inertia 2/5 m r^2).
* **geoms** are imported as *metadata* (type/pos/size/mass in carrier
  frame): the engine's contact layer is sphere/segment/plane penalty
  pairs, so each env decides which imported geoms become colliders.

Out of scope: meshes, tendons/actuators and ``contype``/``conaffinity``
pair filtering. No caller in the package reads an XML file yet.
"""

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ppi_tpu_torch.envs.physics.engine import HINGE, SLIDE, ModelBuilder


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """MuJoCo wxyz quaternion -> rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _euler_to_rot(e: np.ndarray) -> np.ndarray:
    """MuJoCo default eulerseq 'xyz' (extrinsic x, then y, then z)."""
    cx, sx = np.cos(e[0]), np.sin(e[0])
    cy, sy = np.cos(e[1]), np.sin(e[1])
    cz, sz = np.cos(e[2]), np.sin(e[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _frame_of(el: ET.Element) -> Tuple[np.ndarray, np.ndarray]:
    pos = _floats(el.get("pos", "0 0 0"))
    if el.get("quat") is not None:
        rot = _quat_to_rot(_floats(el.get("quat")))
    elif el.get("euler") is not None:
        rot = _euler_to_rot(_floats(el.get("euler")))
    else:
        rot = np.eye(3)
    return pos, rot


def _fullinertia_to_mat(fi: np.ndarray) -> np.ndarray:
    ixx, iyy, izz, ixy, ixz, iyz = fi
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


@dataclasses.dataclass
class _Inertial:
    mass: float
    com: np.ndarray        # in body frame
    inertia: np.ndarray    # 3x3 about com, in body frame


def _parse_inertial(el: Optional[ET.Element]) -> Optional[_Inertial]:
    if el is None:
        return None
    mass = float(el.get("mass"))
    com = _floats(el.get("pos", "0 0 0"))
    if el.get("fullinertia") is not None:
        inertia = _fullinertia_to_mat(_floats(el.get("fullinertia")))
    else:
        diag = np.diag(_floats(el.get("diaginertia")))
        if el.get("quat") is not None:
            r = _quat_to_rot(_floats(el.get("quat")))
            inertia = r @ diag @ r.T
        else:
            inertia = diag
    return _Inertial(mass=mass, com=com, inertia=inertia)


def _geom_inertial(geoms: List[ET.Element]) -> _Inertial:
    """Mass/inertia from geoms with explicit mass (sphere exactly; other
    types as point masses at the geom origin — sufficient for the target
    scenes, where every non-sphere massy body has an explicit inertial)."""
    mass, com = 0.0, np.zeros(3)
    parts = []
    for g in geoms:
        if g.get("mass") is None:
            continue
        m = float(g.get("mass"))
        p, _ = _frame_of(g)
        if g.get("type", "sphere") == "sphere":
            r = _floats(g.get("size"))[0]
            i = (2.0 / 5.0) * m * r * r * np.eye(3)
        else:
            i = np.zeros((3, 3))
        parts.append((m, p, i))
        mass += m
        com += m * p
    if mass <= 0.0:
        return _Inertial(mass=0.0, com=np.zeros(3), inertia=np.zeros((3, 3)))
    com = com / mass
    inertia = np.zeros((3, 3))
    for m, p, i in parts:
        d = p - com
        inertia += i + m * ((d @ d) * np.eye(3) - np.outer(d, d))
    return _Inertial(mass=mass, com=com, inertia=inertia)


def _merge_inertial(a: _Inertial, b: _Inertial) -> _Inertial:
    """Combine two rigid inertials expressed in the SAME frame."""
    mass = a.mass + b.mass
    if mass <= 0.0:
        return _Inertial(mass=0.0, com=np.zeros(3), inertia=np.zeros((3, 3)))
    com = (a.mass * a.com + b.mass * b.com) / mass
    inertia = np.zeros((3, 3))
    for part in (a, b):
        d = part.com - com
        inertia = inertia + part.inertia + part.mass * (
            (d @ d) * np.eye(3) - np.outer(d, d))
    return _Inertial(mass=mass, com=com, inertia=inertia)


def _transform_inertial(inr: _Inertial, pos: np.ndarray,
                        rot: np.ndarray) -> _Inertial:
    """Re-express an inertial given the (pos, rot) of its frame in the
    target frame."""
    return _Inertial(mass=inr.mass, com=pos + rot @ inr.com,
                     inertia=rot @ inr.inertia @ rot.T)


@dataclasses.dataclass
class MjcfGeom:
    name: str
    type: str
    body: int               # builder body id (carrier)
    pos: np.ndarray         # in carrier builder frame
    rot: np.ndarray
    size: np.ndarray
    body_name: str          # mjcf body it was declared under


@dataclasses.dataclass
class MjcfJointSpec:
    """Per-joint overridable physical parameters (importer knobs the MJCF
    hard-constraint model does not carry: soft-limit gain, armature)."""
    limit_k: float = 100.0
    armature: float = 1e-3


@dataclasses.dataclass
class MjcfModel:
    builder: ModelBuilder
    timestep: float
    gravity: np.ndarray
    joint_id: Dict[str, int]                 # joint name -> builder dof
    body_carrier: Dict[str, int]             # mjcf body -> builder body id
    # fixed transform of the mjcf body frame in its carrier builder frame
    body_pos: Dict[str, np.ndarray]
    body_rot: Dict[str, np.ndarray]
    sites: Dict[str, Tuple[int, np.ndarray]]  # name -> (carrier, local pos)
    geoms: List[MjcfGeom]

    def site_local(self, name: str) -> Tuple[int, np.ndarray]:
        return self.sites[name]


def load_mjcf(path: str, root_bodies: Optional[List[str]] = None,
              spec: Optional[MjcfJointSpec] = None,
              joint_overrides: Optional[Dict[str, dict]] = None) -> MjcfModel:
    """Parse an MJCF file into a :class:`ModelBuilder`.

    root_bodies: names of worldbody children to import (default: those with
    at least one non-free joint somewhere below — skips viz-only freejoint
    ghost bodies like the reference scene's ball_pred/ball_true/cup_pred).
    joint_overrides: per-joint-name dict of add_body kwarg overrides
    (e.g. ``{"joints/shoulder_yaw": {"armature": 0.1}}``).
    """
    spec = spec or MjcfJointSpec()
    joint_overrides = joint_overrides or {}
    tree = ET.parse(path)
    mj = tree.getroot()

    option = mj.find("option")
    timestep = float(option.get("timestep", "0.002")) if option is not None \
        else 0.002
    gravity = _floats(option.get("gravity", "0 0 -9.81")) \
        if option is not None else np.array([0.0, 0.0, -9.81])

    # defaults: only the (un-classed) joint defaults matter for dynamics
    joint_default: Dict[str, str] = {}
    default = mj.find("default")
    if default is not None:
        jd = default.find("joint")
        if jd is not None:
            joint_default = dict(jd.attrib)

    def jattr(j: ET.Element, key: str, fallback: str) -> str:
        v = j.get(key)
        if v is None:
            v = joint_default.get(key, fallback)
        return v

    builder = ModelBuilder()
    out = MjcfModel(builder=builder, timestep=timestep, gravity=gravity,
                    joint_id={}, body_carrier={}, body_pos={}, body_rot={},
                    sites={}, geoms=[])

    # pending inertial contributions: carrier builder id -> list of
    # (_Inertial in carrier frame); applied after the tree walk
    pending: Dict[int, List[_Inertial]] = {}

    def add_joint_body(parent_id: int, off_pos: np.ndarray,
                       off_rot: np.ndarray, j: ET.Element,
                       free_part: Optional[Tuple[int, np.ndarray]] = None
                       ) -> int:
        """One builder body for one MJCF joint (or one freejoint part)."""
        if free_part is not None:
            jtype, axis = free_part
            name = None
            damping = 0.0
            friction = 0.0
            limited = False
            rng = (-1e6, 1e6)
        else:
            t = jattr(j, "type", "hinge")
            jtype = HINGE if t == "hinge" else SLIDE
            axis = _floats(jattr(j, "axis", "0 0 1"))
            name = j.get("name")
            damping = float(jattr(j, "damping", "0"))
            friction = float(jattr(j, "frictionloss", "0"))
            limited = jattr(j, "limited", "false") == "true"
            rng = tuple(_floats(j.get("range", "-1e6 1e6"))) if limited \
                else (-1e6, 1e6)
        kwargs = dict(
            parent=parent_id, joint_type=jtype, axis=axis,
            offset_pos=off_pos, offset_rot=off_rot,
            mass=1e-6, com=(0.0, 0.0, 0.0), inertia=np.zeros((3, 3)),
            damping=damping, friction_loss=friction,
            armature=spec.armature,
            q_limit=rng, limit_k=spec.limit_k if limited else 0.0)
        if name is not None and name in joint_overrides:
            kwargs.update(joint_overrides[name])
        bid = builder.add_body(**kwargs)
        if name is not None:
            out.joint_id[name] = bid
        return bid

    def walk(body: ET.Element, carrier: int, c_pos: np.ndarray,
             c_rot: np.ndarray):
        """carrier: builder body id this subtree's frame is expressed in
        (-1 = world); (c_pos, c_rot): this MJCF body's frame in the carrier
        builder frame."""
        name = body.get("name", "")
        b_pos, b_rot = _frame_of(body)
        pos = c_pos + c_rot @ b_pos
        rot = c_rot @ b_rot

        joints = body.findall("joint")
        freejoint = body.find("freejoint")
        geoms = body.findall("geom")
        inertial = _parse_inertial(body.find("inertial"))
        if inertial is None:
            inertial = _geom_inertial(geoms)

        if freejoint is not None:
            # 3 slides + 3 hinges anchored at the body frame origin
            axes = [(SLIDE, np.eye(3)[i]) for i in range(3)] + \
                   [(HINGE, np.eye(3)[i]) for i in range(3)]
            bid = carrier
            off_p, off_r = pos, rot
            for part in axes:
                bid = add_joint_body(bid, off_p, off_r, None, free_part=part)
                off_p, off_r = np.zeros(3), np.eye(3)
            fj_name = freejoint.get("name")
            if fj_name is not None:
                out.joint_id[fj_name] = bid
            carrier, pos, rot = bid, np.zeros(3), np.eye(3)
        elif joints:
            # chain: anchor each joint at its own pos within the body frame
            anchor_prev = np.zeros(3)
            bid = carrier
            off_p, off_r = pos, rot
            for k, j in enumerate(joints):
                a = _floats(j.get("pos", joint_default.get("pos", "0 0 0")))
                if k == 0:
                    bid = add_joint_body(bid, off_p + off_r @ a, off_r, j)
                else:
                    bid = add_joint_body(bid, a - anchor_prev, np.eye(3), j)
                anchor_prev = a
            # the body frame sits at -anchor_prev in the last joint frame
            carrier, pos, rot = bid, -anchor_prev, np.eye(3)

        out.body_carrier[name] = carrier
        out.body_pos[name] = pos
        out.body_rot[name] = rot

        if inertial.mass > 0.0:
            pending.setdefault(carrier, []).append(
                _transform_inertial(inertial, pos, rot))

        for s in body.findall("site"):
            s_pos, _ = _frame_of(s)
            out.sites[s.get("name")] = (carrier, pos + rot @ s_pos)

        for g in geoms:
            g_pos, g_rot = _frame_of(g)
            out.geoms.append(MjcfGeom(
                name=g.get("name", ""), type=g.get("type", "sphere"),
                body=carrier, pos=pos + rot @ g_pos, rot=rot @ g_rot,
                size=_floats(g.get("size", "0")), body_name=name))

        for child in body.findall("body"):
            walk(child, carrier, pos, rot)

    def has_real_joint(body: ET.Element) -> bool:
        if body.findall("joint"):
            return True
        return any(has_real_joint(c) for c in body.findall("body"))

    world = mj.find("worldbody")
    for body in world.findall("body"):
        name = body.get("name", "")
        if root_bodies is not None:
            if name not in root_bodies:
                continue
        elif not has_real_joint(body):
            continue  # viz-only ghost (freejoint, no articulation below)
        walk(body, -1, np.zeros(3), np.eye(3))

    # fold accumulated inertials into their carrier builder bodies
    # (carrier -1 = world: a jointless root body is static scenery — its
    # mass is unreachable by any dof and is correctly dropped)
    for bid, parts in pending.items():
        if bid < 0:
            continue
        total = _Inertial(mass=0.0, com=np.zeros(3),
                          inertia=np.zeros((3, 3)))
        for p in parts:
            total = _merge_inertial(total, p)
        body = builder._bodies[bid]
        base = _Inertial(mass=body["mass"] - 1e-6,
                         com=np.asarray(body["com"], np.float64),
                         inertia=np.asarray(body["inertia"], np.float64))
        if base.mass > 1e-9:
            total = _merge_inertial(total, base)
        body["mass"] = float(total.mass + 1e-6)
        body["com"] = total.com.astype(np.float32)
        body["inertia"] = total.inertia.astype(np.float32)

    builder.gravity = tuple(gravity)
    return out
