"""In-hand pen reorientation with five Adroit-class digits (pen-v0-adroit).

Port of ``ppi_tpu/envs/pen_adroit.py``: pen-v0's compliant free pen is
turned by five three-hinge digits of ``envs.hand.add_digit3`` (abduction,
MCP, PIP: the mj_envs knuckle layout), mounted on the world as the frozen
forearm is. Four fingers below the rod point up, staggered along its axis;
an opposing thumb above mid-rod points down. The abduction hinges turn
about y, so each fingertip also sweeps along the rod. 15 actuated joints,
20 DoF. The reward shape, the compliant hold, the sampled goal (yaw/pitch
~ U(-1, 1) rad) and the success test are pen-v0's, so the env is
pen-v0-hand's class with another scene and gains.

The JAX env's default engine is ``engine="stacked"``, XLA's assembly of
the same dynamics. The port runs the scalar program only: eagerly on the
CPU and, on the card, as the rollout kernel's generated body. ``step`` on a
CUDA state is one launch of that kernel.
"""

import dataclasses

import numpy as np

from ppi_tpu_torch.envs.hand import add_digit3, digit_spheres
from ppi_tpu_torch.envs.pen import HOLD_POS, PEN_HALF
from ppi_tpu_torch.envs.pen_hand import PenHand, PenHandState
from ppi_tpu_torch.envs.physics.engine import HINGE, SLIDE, ModelBuilder

# dof order: pen x,y,z slides, yaw, pitch; then the fingers FF, MF, RF, LF
# (+x to -x along the rod) and the thumb, each (ABD, MCP, PIP)
(PEN_X, PEN_Y, PEN_Z, PEN_YAW, PEN_PITCH,
 FF_ABD, FF_MCP, FF_PIP,
 MF_ABD, MF_MCP, MF_PIP,
 RF_ABD, RF_MCP, RF_PIP,
 LF_ABD, LF_MCP, LF_PIP,
 TH_ABD, TH_MCP, TH_PIP) = range(20)

N_ACT = 15
L1, L2 = 0.055, 0.05          # digit link lengths (pen-v0-hand's)
DIGIT_DROP = 0.06             # finger mounts this far below the rod centre
THUMB_RISE = 0.07             # thumb mount this far above

# finger mounts staggered along the rod (world x, the frozen-forearm frame)
_FINGER_X = (0.07, 0.025, -0.025, -0.07)

_ABD = (-0.45, 0.45)
_MCP = (-1.3, 1.3)
_PIP = (-2.2, 2.2)
_LOW = (_ABD[0], _MCP[0], _PIP[0]) * 5
_HIGH = (_ABD[1], _MCP[1], _PIP[1]) * 5


def _build_model():
    b = ModelBuilder()
    # --- pen: pen-v0's compliant free body ---
    p = b.add_body(parent=-1, joint_type=SLIDE, axis=(1, 0, 0),
                   offset_pos=HOLD_POS, mass=1e-3, armature=1e-4,
                   damping=0.0, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=SLIDE, axis=(0, 1, 0),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-4,
                   damping=0.5, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=SLIDE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-4,
                   damping=1.0, spring_k=50.0, spring_ref=0.0)
    p = b.add_body(parent=p, joint_type=HINGE, axis=(0, 0, 1),
                   offset_pos=(0, 0, 0), mass=1e-3, armature=1e-3,
                   damping=0.05)
    b.add_body(parent=p, joint_type=HINGE, axis=(0, 1, 0),
               offset_pos=(0, 0, 0), mass=0.05,
               inertia=np.diag([1e-4, 3e-4, 3e-4]), armature=1e-3,
               damping=0.05)
    # --- five world-mounted digits: curl about x (the tips sweep the y-z
    # plane), abduction about y (the tips sweep along the rod) ---
    up, down = (0.0, 0.0, 1.0), (0.0, 0.0, -1.0)
    digit_cfg = dict(abd_axis=(0, 1, 0), curl_axis=(1, 0, 0),
                     abd_limits=_ABD, mcp_limits=_MCP, pip_limits=_PIP,
                     link1=L1, link2=L2, damping_abd=0.35, damping1=0.35,
                     damping2=0.3)
    ids = [add_digit3(b, -1, (x + HOLD_POS[0], 0.0,
                              HOLD_POS[2] - DIGIT_DROP),
                      direction=up, **digit_cfg) for x in _FINGER_X]
    ids.append(add_digit3(b, -1, (HOLD_POS[0], 0.0,
                                  HOLD_POS[2] + THUMB_RISE),
                          direction=down, **digit_cfg))

    # geoms: pen end spheres define the rod segment; a proximal and a tip
    # sphere per digit
    end_a = b.add_sphere(PEN_PITCH, (PEN_HALF, 0, 0), 0.012)
    end_b = b.add_sphere(PEN_PITCH, (-PEN_HALF, 0, 0), 0.012)
    tip_geoms = []
    for (_, mcp, pip), direction in zip(ids, [up] * 4 + [down]):
        prox, tip = digit_spheres(b, mcp, pip, link1=L1, link2=L2,
                                  prox_radius=0.015, tip_radius=0.015,
                                  direction=direction)
        b.add_contact_sphere_segment(prox, end_a, end_b)
        b.add_contact_sphere_segment(tip, end_a, end_b)
        tip_geoms.append(tip)
    # pen-v0's contact material
    b.contact_stiffness = 2e3
    b.contact_damping = 5.0
    b.friction_mu = 0.8
    b.friction_vel_k = 30.0
    return b.finalize(), (end_a, end_b), tuple(tip_geoms)


# the state of pen-v0-hand: physics, the sampled goal axis, the step count
PenAdroitState = PenHandState


@dataclasses.dataclass(frozen=True)
class PenAdroit(PenHand):
    """pen-v0-class task on five three-hinge digits; actions are PD
    position targets for the 15 digit joints."""

    action_dim: int = N_ACT
    kp_abd: float = 2.0
    kd_abd: float = 0.2

    name = "pen-v0-adroit"
    # one thread's dependent chain bounds the lane layout here: the
    # rollout kernel runs one rollout a warp (rollout_kernel.kernel_layout);
    # pen-v0-hand, the parent, takes the partitioned split layout, and its
    # split body here stays list-scheduled
    scalar_kernel_layout = "warp"
    scalar_split_partition = None

    _low, _high = _LOW, _HIGH
    # alternate MCP curls form a zigzag cradle under the rod (pen-v0-hand's
    # cradle, extended); the thumb lifted above
    _qpos0 = ((0.0,) * 5
              + (0.0, 0.35, 0.0, 0.0, -0.35, 0.0) * 2
              + (0.0, 0.3, 0.0))
    _build = staticmethod(_build_model)

    def _gains(self):
        return ([self.kp_abd, self.kp, self.kp] * 5,
                [self.kd_abd, self.kd, self.kd] * 5)
