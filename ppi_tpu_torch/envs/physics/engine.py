"""Articulated model description: the builder, the model and the state.

Port of the data half of ``ppi_tpu/envs/physics/engine.py``. The model is a
frozen dataclass of numpy f32/int32 arrays plus the static topology, so the
scalar program (``engine_soa``) folds every parameter into Python floats at
build time, exactly as the JAX trace does. The tensor engine (``fk``,
``mass_matrix``, ...) is not part of this package yet.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch

HINGE, SLIDE = 0, 1

# the numeric fields of ArticulatedModel, in declaration order
MODEL_FIELDS = (
    "offset_pos", "offset_rot", "axis", "mass", "com", "inertia", "damping",
    "friction_loss", "armature", "spring_k", "spring_ref", "q_limit",
    "limit_k", "sphere_body", "sphere_pos", "sphere_radius", "plane_normal",
    "plane_offset", "pair_sphere_plane", "pair_sphere_sphere",
    "pair_sphere_segment", "gravity", "contact_stiffness", "contact_damping",
    "friction_mu", "friction_vel_k",
)


@dataclasses.dataclass(frozen=True, eq=False)
class ArticulatedModel:
    """Numeric model parameters (numpy) and static topology.

    Per-body arrays have nb = n bodies = n dofs rows; see the JAX model for
    the meaning of each field."""

    offset_pos: np.ndarray      # (nb, 3) joint origin in parent joint frame
    offset_rot: np.ndarray      # (nb, 3, 3)
    axis: np.ndarray            # (nb, 3) joint axis in own joint frame
    mass: np.ndarray            # (nb,)
    com: np.ndarray             # (nb, 3) body com in joint frame
    inertia: np.ndarray         # (nb, 3, 3) about com, in joint frame
    damping: np.ndarray         # (nb,)
    friction_loss: np.ndarray   # (nb,) dry (Coulomb) friction force bound
    armature: np.ndarray        # (nb,)
    spring_k: np.ndarray        # (nb,)
    spring_ref: np.ndarray      # (nb,)
    q_limit: np.ndarray         # (nb, 2) soft joint limits (lo, hi)
    limit_k: np.ndarray         # (nb,)
    sphere_body: np.ndarray     # (ns,) int32
    sphere_pos: np.ndarray      # (ns, 3)
    sphere_radius: np.ndarray   # (ns,)
    plane_normal: np.ndarray    # (np_, 3)
    plane_offset: np.ndarray    # (np_,)
    pair_sphere_plane: np.ndarray    # (npp, 2) int32
    pair_sphere_sphere: np.ndarray   # (nss, 2) int32
    pair_sphere_segment: np.ndarray  # (nsg, 3) int32
    gravity: np.ndarray         # (3,)
    contact_stiffness: np.ndarray   # ()
    contact_damping: np.ndarray     # ()
    friction_mu: np.ndarray         # ()
    friction_vel_k: np.ndarray      # ()
    parents: Tuple[int, ...] = ()
    joint_types: Tuple[int, ...] = ()

    @property
    def nq(self) -> int:
        return len(self.parents)


@dataclasses.dataclass(frozen=True)
class PhysicsState:
    qpos: torch.Tensor  # (..., nq)
    qvel: torch.Tensor  # (..., nq)


@dataclasses.dataclass
class ModelBuilder:
    """Imperative scene construction -> immutable ArticulatedModel."""

    def __post_init__(self):
        self._bodies = []
        self._spheres = []
        self._planes = []
        self._sp_pairs = []
        self._ss_pairs = []
        self._sseg_pairs = []
        self.gravity = (0.0, 0.0, -9.81)
        self.contact_stiffness = 1e4
        self.contact_damping = 30.0
        self.friction_mu = 1.0
        self.friction_vel_k = 30.0

    def add_body(self, parent: int, joint_type: int, axis, offset_pos,
                 offset_rot=None, mass=1.0, com=(0.0, 0.0, 0.0),
                 inertia=None, damping=0.1, armature=0.01, spring_k=0.0,
                 spring_ref=0.0, q_limit=(-1e6, 1e6), limit_k=0.0,
                 friction_loss=0.0) -> int:
        if offset_rot is None:
            offset_rot = np.eye(3)
        if inertia is None:
            inertia = 0.05 * mass * np.eye(3)
        self._bodies.append(dict(
            parent=parent, joint_type=joint_type,
            axis=np.asarray(axis, np.float32),
            offset_pos=np.asarray(offset_pos, np.float32),
            offset_rot=np.asarray(offset_rot, np.float32),
            mass=float(mass), com=np.asarray(com, np.float32),
            inertia=np.asarray(inertia, np.float32),
            damping=float(damping), friction_loss=float(friction_loss),
            armature=float(armature),
            spring_k=float(spring_k), spring_ref=float(spring_ref),
            q_limit=np.asarray(q_limit, np.float32),
            limit_k=float(limit_k)))
        return len(self._bodies) - 1

    def add_planar_base(self, offset_pos, mass=1e-3, axis_forward=(1, 0, 0),
                        axis_up=(0, 0, 1)) -> int:
        """A planar free base: a slide along ``axis_forward`` carrying a
        slide along ``axis_up``, both near-massless proxy bodies. Returns
        the second slide's id; the caller adds the pitch hinge with the real
        mass and geometry as its child."""
        x = self.add_body(parent=-1, joint_type=SLIDE, axis=axis_forward,
                          offset_pos=offset_pos, mass=mass, damping=0.0,
                          armature=1e-4)
        return self.add_body(parent=x, joint_type=SLIDE, axis=axis_up,
                             offset_pos=(0, 0, 0), mass=mass, damping=0.0,
                             armature=1e-4)

    def add_sphere(self, body: int, pos, radius: float) -> int:
        self._spheres.append((body, np.asarray(pos, np.float32),
                              float(radius)))
        return len(self._spheres) - 1

    def add_plane(self, normal=(0.0, 0.0, 1.0), offset=0.0) -> int:
        self._planes.append((np.asarray(normal, np.float32), float(offset)))
        return len(self._planes) - 1

    def add_contact_sphere_plane(self, sphere: int, plane: int):
        self._sp_pairs.append((sphere, plane))

    def add_contact_sphere_sphere(self, a: int, b: int):
        self._ss_pairs.append((a, b))

    def add_contact_sphere_segment(self, sphere: int, end_a: int, end_b: int):
        self._sseg_pairs.append((sphere, end_a, end_b))

    def finalize(self) -> ArticulatedModel:
        get = lambda k: np.stack([np.asarray(b[k], np.float32)
                                  for b in self._bodies])
        spheres = self._spheres
        as_i = lambda rows, w: (np.asarray(rows, np.int32).reshape(-1, w)
                                if rows else np.zeros((0, w), np.int32))
        f32 = lambda x: np.asarray(x, np.float32)
        return ArticulatedModel(
            offset_pos=get("offset_pos"),
            offset_rot=get("offset_rot"),
            axis=get("axis"),
            mass=get("mass"),
            com=get("com"),
            inertia=get("inertia"),
            damping=get("damping"),
            friction_loss=get("friction_loss"),
            armature=get("armature"),
            spring_k=get("spring_k"),
            spring_ref=get("spring_ref"),
            q_limit=get("q_limit"),
            limit_k=get("limit_k"),
            sphere_body=np.asarray([s[0] for s in spheres], np.int32),
            sphere_pos=(np.stack([s[1] for s in spheres]) if spheres
                        else np.zeros((0, 3), np.float32)),
            sphere_radius=f32([s[2] for s in spheres]),
            plane_normal=(np.stack([p[0] for p in self._planes])
                          if self._planes else np.zeros((0, 3), np.float32)),
            plane_offset=f32([p[1] for p in self._planes]),
            pair_sphere_plane=as_i(self._sp_pairs, 2),
            pair_sphere_sphere=as_i(self._ss_pairs, 2),
            pair_sphere_segment=as_i(self._sseg_pairs, 3),
            gravity=f32(self.gravity),
            contact_stiffness=f32(self.contact_stiffness),
            contact_damping=f32(self.contact_damping),
            friction_mu=f32(self.friction_mu),
            friction_vel_k=f32(self.friction_vel_k),
            parents=tuple(b["parent"] for b in self._bodies),
            joint_types=tuple(b["joint_type"] for b in self._bodies),
        )
