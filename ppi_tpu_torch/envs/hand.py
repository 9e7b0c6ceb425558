"""Shared multi-digit hand builder for the dexterous hand scenes.

Port of ``ppi_tpu/envs/hand.py``: a two-hinge digit (MCP + PIP) carrying a
proximal and a tip contact sphere, and the three-hinge Adroit-class digit
(abduction + MCP + PIP). Each scene chooses mount points, hinge axes and
limits for its grasp.

``expert_start`` and ``hold_target`` are the scripted experts' shared
steps (each hand module's ``scripted_*``): the JAX experts' ``run_scan``,
a ``jax.lax.scan`` of ``env.step`` under one jit, is here a Python loop
of ``env.step``, one rollout-kernel launch a step on the card.
"""

import numpy as np
import torch

from ppi_tpu_torch.envs.physics.engine import HINGE


def expert_start(env, state0, device):
    """``state0``, or where it is None ``env``'s reset from a generator
    seeded 0 on ``device`` (the JAX experts reset from ``key(0)``, whose
    draws differ: ``convert.KEY0_DOOR_FRAME`` and ``KEY0_HAMMER_BOARD``
    pin JAX's scenes)."""
    if state0 is not None:
        return state0
    return env.reset(torch.Generator(device).manual_seed(0), device)


def hold_target(env, state, target, n: int, frames=None):
    """``n`` control steps of ``env`` from ``state`` toward the held PD
    ``target``; with ``frames`` (a list) the (n, nq) qpos trajectory is
    appended to it as numpy. Returns the final state."""
    qs = []
    for _ in range(n):
        state, _ = env.step(state, target)
        if frames is not None:
            qs.append(state.physics.qpos)
    if frames is not None:
        frames.append(torch.stack(qs).cpu().numpy())
    return state


def add_digit(b, parent, mount, axis, mcp_limits, pip_limits,
              link1=0.05, link2=0.045, mass1=0.08, mass2=0.05,
              com1=0.025, com2=0.02, direction=(1.0, 0.0, 0.0),
              damping1=0.25, damping2=0.2, armature1=0.02,
              armature2=0.015, limit_k=20.0):
    """Two-hinge digit on ``parent``; returns (mcp_body, pip_body).

    The MCP hinge sits at ``mount`` (parent frame); the PIP hinge sits
    ``link1`` along ``direction`` (a unit vector in the digit frame).
    ``link2`` is the PIP link's length, where ``digit_spheres`` puts the
    tip."""
    del link2
    d = np.asarray(direction, np.float64)
    mcp = b.add_body(parent=parent, joint_type=HINGE, axis=axis,
                     offset_pos=tuple(mount), mass=mass1,
                     com=tuple(com1 * d),
                     inertia=np.diag([3e-5, 3e-5, 3e-5]), damping=damping1,
                     armature=armature1, q_limit=mcp_limits, limit_k=limit_k)
    pip = b.add_body(parent=mcp, joint_type=HINGE, axis=axis,
                     offset_pos=tuple(link1 * d), mass=mass2,
                     com=tuple(com2 * d),
                     inertia=np.diag([2e-5, 2e-5, 2e-5]), damping=damping2,
                     armature=armature2, q_limit=pip_limits, limit_k=limit_k)
    return mcp, pip


def digit_spheres(b, mcp, pip, link1=0.05, link2=0.045,
                  prox_radius=0.016, tip_radius=0.014,
                  direction=(1.0, 0.0, 0.0)):
    """Standard contact spheres for a digit: proximal mid-link + fingertip."""
    d = np.asarray(direction, np.float64)
    prox = b.add_sphere(mcp, tuple(link1 * 0.6 * d), prox_radius)
    tip = b.add_sphere(pip, tuple(link2 * d), tip_radius)
    return prox, tip


def add_digit3(b, parent, mount, abd_axis, curl_axis, abd_limits,
               mcp_limits, pip_limits, link1=0.05, link2=0.045,
               mass1=0.08, mass2=0.05, com1=0.025, com2=0.02,
               direction=(1.0, 0.0, 0.0), damping_abd=0.35,
               damping1=0.25, damping2=0.2, armature_abd=0.02,
               armature1=0.02, armature2=0.015, limit_k=20.0):
    """Three-hinge Adroit-class digit: ABD (splay) + MCP + PIP.

    The abduction hinge is a near-massless proxy body at ``mount``
    rotating about ``abd_axis``; the MCP and PIP links ride it as in
    ``add_digit``, curling about ``curl_axis``. Returns (abd_body,
    mcp_body, pip_body)."""
    del link2
    d = np.asarray(direction, np.float64)
    abd = b.add_body(parent=parent, joint_type=HINGE, axis=abd_axis,
                     offset_pos=tuple(mount), mass=0.01,
                     com=(0.0, 0.0, 0.0),
                     inertia=np.diag([5e-6, 5e-6, 5e-6]),
                     damping=damping_abd, armature=armature_abd,
                     q_limit=abd_limits, limit_k=limit_k)
    mcp = b.add_body(parent=abd, joint_type=HINGE, axis=curl_axis,
                     offset_pos=(0.0, 0.0, 0.0), mass=mass1,
                     com=tuple(com1 * d),
                     inertia=np.diag([3e-5, 3e-5, 3e-5]), damping=damping1,
                     armature=armature1, q_limit=mcp_limits, limit_k=limit_k)
    pip = b.add_body(parent=mcp, joint_type=HINGE, axis=curl_axis,
                     offset_pos=tuple(link1 * d), mass=mass2,
                     com=tuple(com2 * d),
                     inertia=np.diag([2e-5, 2e-5, 2e-5]), damping=damping2,
                     armature=armature2, q_limit=pip_limits, limit_k=limit_k)
    return abd, mcp, pip
