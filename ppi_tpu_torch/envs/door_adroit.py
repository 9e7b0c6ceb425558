"""Door-opening with a five-digit Adroit-class hand (door-v0-adroit).

Port of ``ppi_tpu/envs/door_adroit.py``: the door-v0-hand arm gains a
2-DoF wrist (pronation, deviation) and five three-hinge digits (abduction,
MCP, PIP; four fingers above the handle bar, an opposing thumb below): 21
actuated joints, 23 DoF with the door and latch. The task mechanics (the
latch bolt's kinematic clamp, the seal spring, the staged reward) and the
per-episode door frame are door-v0-hand's, so the env is that class with
another scene and gains.

The JAX env's default engine is ``engine="stacked"``, XLA's assembly of
the same dynamics, kept there for compile time. The port runs the scalar
program only: eagerly on the CPU and, on the card, as the rollout kernel's
generated body (the kernel's semantics on the TPU too).

The scripted expert (``scripted_open``) is door-v0-hand's strategy on this
hand (``door_hand.open_door``), its palm IK (``door_hand._ik`` over the 21
actuated joints) one palm-IK kernel launch on the card.
"""

import dataclasses

import numpy as np

from ppi_tpu_torch.envs.door_hand import (  # noqa: F401  (_ik: the expert's)
    DoorHand, DoorHandState, _ik, add_arm, add_door, add_door_geoms,
    finish_contacts, open_door)
from ppi_tpu_torch.envs.hand import add_digit3
from ppi_tpu_torch.envs.physics.engine import HINGE, ModelBuilder

# dof indices: 4 arm, 2 wrist, 5 x (ABD, MCP, PIP), door, latch
(YAW, SHOULDER, ELBOW, WRIST, PRON, DEV,
 FF_ABD, FF_MCP, FF_PIP,
 MF_ABD, MF_MCP, MF_PIP,
 RF_ABD, RF_MCP, RF_PIP,
 LF_ABD, LF_MCP, LF_PIP,
 TH_ABD, TH_MCP, TH_PIP,
 DOOR, LATCH) = range(23)

N_ACT = 21  # every arm + wrist + digit joint is position-servoed

_FING = dict(abd=(-0.25, 0.25), mcp=(-0.3, 1.6), pip=(0.0, 1.8))
_THUMB = dict(abd=(-0.5, 0.5), mcp=(-1.6, 0.3), pip=(-1.8, 0.0))

_LOW = ((-1.5, -1.6, -2.3, -2.0, -1.0, -0.6)
        + (_FING["abd"][0], _FING["mcp"][0], _FING["pip"][0]) * 4
        + (_THUMB["abd"][0], _THUMB["mcp"][0], _THUMB["pip"][0]))
_HIGH = ((1.5, 1.6, 2.3, 2.0, 1.0, 0.6)
         + (_FING["abd"][1], _FING["mcp"][1], _FING["pip"][1]) * 4
         + (_THUMB["abd"][1], _THUMB["mcp"][1], _THUMB["pip"][1]))

# finger mounts in the hand (deviation-body) frame: digits point +x,
# fingers splayed across y above the handle plane, thumb centred below
_FINGER_Y = (0.075, 0.025, -0.025, -0.075)


def _build_model():
    b = ModelBuilder()
    add_arm(b, 0.4, (0.05, 0, 0))
    # 2-DoF wrist: pronation about the forearm axis, then deviation about
    # z; the deviation body is the palm and carries the hand's mass
    b.add_body(parent=WRIST, joint_type=HINGE, axis=(1, 0, 0),
               offset_pos=(0.08, 0, 0), mass=0.05,
               inertia=np.diag([2e-5, 2e-5, 2e-5]), damping=0.5,
               armature=0.02, q_limit=(_LOW[PRON], _HIGH[PRON]),
               limit_k=30.0)
    b.add_body(parent=PRON, joint_type=HINGE, axis=(0, 0, 1),
               offset_pos=(0.02, 0, 0), mass=0.35, com=(0.06, 0, 0),
               inertia=np.diag([4e-4, 4e-4, 4e-4]), damping=0.5,
               armature=0.02, q_limit=(_LOW[DEV], _HIGH[DEV]), limit_k=30.0)
    for y in _FINGER_Y:
        add_digit3(b, DEV, (0.10, y, 0.03), abd_axis=(0, 0, 1),
                   curl_axis=(0, 1, 0), abd_limits=_FING["abd"],
                   mcp_limits=_FING["mcp"], pip_limits=_FING["pip"])
    add_digit3(b, DEV, (0.06, 0.0, -0.05), abd_axis=(0, 0, 1),
               curl_axis=(0, 1, 0), abd_limits=_THUMB["abd"],
               mcp_limits=_THUMB["mcp"], pip_limits=_THUMB["pip"])
    door, latch = add_door(b)

    palm = b.add_sphere(DEV, (0.08, 0, 0), 0.04)
    spheres = []
    for mcp, pip in ((FF_MCP, FF_PIP), (MF_MCP, MF_PIP), (RF_MCP, RF_PIP),
                     (LF_MCP, LF_PIP), (TH_MCP, TH_PIP)):
        spheres += [b.add_sphere(mcp, (0.03, 0, 0), 0.015),
                    b.add_sphere(pip, (0.045, 0, 0), 0.013)]
    handle, panel = add_door_geoms(b, door, latch)
    finish_contacts(b, palm, spheres, handle, panel,
                    (spheres[3], spheres[9]))
    return b.finalize(), palm, handle


# the state of door-v0-hand: physics, the sampled frame, the step count
DoorAdroitState = DoorHandState


@dataclasses.dataclass(frozen=True)
class DoorAdroit(DoorHand):
    """door-v0-class task on the five-digit Adroit-class hand; actions are
    PD position targets for the 21 arm + wrist + digit joints."""

    action_dim: int = N_ACT
    kp_wrist: float = 15.0
    kd_wrist: float = 1.2
    kp_hand: float = 5.0
    kd_hand: float = 0.35
    kp_abd: float = 3.0
    kd_abd: float = 0.3

    name = "door-v0-adroit"
    # the body is too large for one thread: the rollout kernel runs one
    # rollout a warp (rollout_kernel.kernel_layout)
    scalar_kernel_layout = "warp"

    scalar_dyn_body = DOOR
    _latch = LATCH
    _low, _high = _LOW, _HIGH
    _qpos0 = ((0.0, 0.6, -0.8, 0.2, 0.0, 0.0)   # arm + wrist
              + (0.0, 0.3, 0.4) * 4             # fingers curled ajar
              + (0.0, -0.3, -0.4)               # thumb
              + (0.0, 0.0))                     # door, latch
    _build = staticmethod(_build_model)

    def _gains(self):
        digit = [self.kp_abd, self.kp_hand, self.kp_hand] * 5
        digit_d = [self.kd_abd, self.kd_hand, self.kd_hand] * 5
        return ([self.kp] * 4 + [self.kp_wrist] * 2 + digit,
                [self.kd] * 4 + [self.kd_wrist] * 2 + digit_d)


# ---------------------------------------------------------------------------
# scripted expert (feasibility oracle + render demo)
# ---------------------------------------------------------------------------

# digit postures: (ABD, MCP, PIP) x 4 fingers + thumb
_CURL_CLEAR = (0.0, 1.4, 1.6) * 4 + (0.0, -1.2, -1.4)


def scripted_open(env, state0=None, log=None, frames=None, device="cuda"):
    """Hand-scripted door opening on the Adroit-class hand: servo to a
    pre-press posture above the handle bar (the digits curled clear),
    press the latch past the unlock angle with the palm heel, withdraw
    (the seal spring pops the bolt-free door ajar), then sweep the panel
    open in at most 14 passes (~0.04-0.05 rad each through the reach
    annulus). ``door_hand.scripted_open``'s strategy and arguments;
    returns (final state, info)."""
    state, door = open_door(
        env, state0, log, frames, curl=_CURL_CLEAR,
        neutral=(0.0, 0.3, -0.6, 0.3, 0.0, 0.0) + _CURL_CLEAR, sweeps=14,
        device=device)
    return state, {"door": door, "success": bool(env.success(state))}
