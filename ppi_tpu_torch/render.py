"""Episode rendering to GIF / video: schematic 2-D views of the scenes.

Port of ``ppi_tpu/render.py``. Each ``render_*`` draws one frame a step of
an episode's ``qpos`` history (numpy or a tensor, on any device) and
writes it by the path's suffix: ``.gif`` through ``utils.video.save_gif``,
anything else (``.avi``, ``.mp4``) through ``VideoRenderStream``.

The kinematics of the whole history come from one call of the scalar
program: ``engine_soa.make_body_frames_soa`` and the env's
``make_sites_soa`` take the T frames as T lanes (the history's device; a
numpy history goes to ``device``, the card unless the caller names
another), and the frames are drawn from one host copy. The JAX package
runs FK once a frame on the host.

``trace_bic_trajectory`` records a ball-in-a-cup trajectory step by step
for ``render_ball_in_a_cup``: the scalar program at one lane on the host
over ``numpy.float32`` scalars (single precision as the kernel computes,
a few ms a step), since the ball-in-a-cup kernel returns only final states
and the eager program is ~23k launches a step on the card.
"""

import math
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch.envs.physics.engine_soa import make_body_frames_soa
from ppi_tpu_torch.utils.plotting import pyplot
from ppi_tpu_torch.utils.video import VideoRenderStream
from ppi_tpu_torch.utils.video import save_gif as write_gif


def _fig(xlim, ylim, figsize=(5, 5)):
    fig, ax = pyplot().subplots(figsize=figsize)
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.axis("off")
    return fig, ax


def _rasterize(draw_frame, t, xlim, ylim):
    """Frame ``t`` drawn by ``draw_frame(ax, t)``: (H, W, 3) uint8."""
    fig, ax = _fig(xlim, ylim)
    draw_frame(ax, t)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    pyplot().close(fig)
    return buf


def save_gif(path, draw_frame, n_frames: int, xlim=(-1.5, 1.5),
             ylim=(-0.2, 2.2), fps: int = 25, stride: int = 1):
    """Render ``draw_frame(ax, t)`` for t in range(0, n_frames, stride) and
    write a GIF."""
    frames = [_rasterize(draw_frame, t, xlim, ylim)
              for t in range(0, n_frames, stride)]
    return write_gif(path, frames, fps=fps)


def save_video(path, draw_frame, n_frames: int, xlim=(-1.5, 1.5),
               ylim=(-0.2, 2.2), fps: int = 25, stride: int = 1):
    """Like ``save_gif`` but streamed through ``VideoRenderStream`` (mp4
    through imageio-ffmpeg where present, else the MJPEG AVI muxer);
    returns the path written."""
    with VideoRenderStream(Path(path), fps=fps) as stream:
        for t in range(0, n_frames, stride):
            stream.append(_rasterize(draw_frame, t, xlim, ylim))
    return stream.path


def _save(path, draw, n_frames, **kw):
    """Dispatch on suffix: .gif through ``save_gif``, anything else
    through the ``VideoRenderStream`` backends (.mp4 / .avi)."""
    if Path(path).suffix == ".gif":
        return save_gif(path, draw, n_frames, **kw)
    return save_video(path, draw, n_frames, **kw)


def _history(qpos_history, device):
    """The history as an f32 tensor: a tensor stays on its device, numpy
    goes to ``device``."""
    if isinstance(qpos_history, torch.Tensor):
        return qpos_history.to(torch.float32)
    return torch.as_tensor(np.asarray(qpos_history), dtype=torch.float32,
                           device=device)


def _host(*xs):
    return tuple(x.detach().cpu().numpy() for x in xs)


def _vec(x, default, like):
    """A per-episode vector (frame, board, goal) as an f32 tensor on the
    history's device, ``default`` where ``x`` is None."""
    x = default if x is None else x
    if isinstance(x, torch.Tensor):
        return x.to(like.device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def body_frames(model, qpos, dyn_body=None, body_pos=None):
    """(rot (T, nb, 3, 3), pos (T, nb, 3)) as numpy, for every frame of the
    (T, nq) ``qpos`` at once (its frames are the scalar program's lanes)."""
    frames = make_body_frames_soa(model, dyn_body=dyn_body)
    return _host(*frames(qpos, body_pos))


def render_door(env, qpos_history, path, stride=2, frame=None,
                device="cuda"):
    """Top-down schematic of the door task: arm links, door panel, latch.
    ``frame`` is the episode's sampled door-frame origin (defaults to the
    nominal scene)."""
    from ppi_tpu_torch.envs.door import DOOR, FRAME
    q = _history(qpos_history, device)
    fr = _vec(frame, FRAME, q)
    _, pos = body_frames(env._model, q, DOOR, fr)
    pts, = _host(env._sites_soa(q, fr))
    qh, = _host(q)
    palm = pts[:, env._palm_geom]
    handle = 0.5 * (pts[:, env._handle_geoms[0]]
                    + pts[:, env._handle_geoms[1]])

    def draw(ax, t):
        # arm in the x-y plane (top-down)
        xs = list(pos[t, :4, 0]) + [float(palm[t, 0])]
        ys = list(pos[t, :4, 1]) + [float(palm[t, 1])]
        ax.plot(xs, ys, "o-", lw=3, color="C0")
        ax.plot([float(palm[t, 0])], [float(palm[t, 1])], "o", ms=10,
                color="C0")
        # door panel: hinge + panel capsule endpoints
        hinge = pos[t, 4, :2]
        panel_end = pts[t, 4, :2]  # d_b sphere
        ax.plot([hinge[0], panel_end[0]], [hinge[1], panel_end[1]],
                lw=5, color="C1")
        ax.plot(*handle[t, :2], "s", ms=8, color="C3")
        ax.set_title(f"door={qh[t, 4]:.2f} latch={qh[t, 5]:.2f}")

    return _save(path, draw, qh.shape[0], xlim=(-0.3, 1.3),
                 ylim=(-0.9, 0.7), stride=stride)


def render_door_hand(env, qpos_history, path, stride=2, frame=None,
                     device="cuda"):
    """Top-down schematic of the hand-embodiment door task: arm links,
    three digits, door panel, handle bar (``envs.door_hand.DoorHand``).
    ``frame`` is the episode's sampled door-frame origin (defaults to the
    nominal scene)."""
    from ppi_tpu_torch.envs.door_hand import DOOR, FRAME, LATCH
    q = _history(qpos_history, device)
    fr = _vec(frame, FRAME, q)
    _, pos = body_frames(env._model, q, DOOR, fr)
    pts, = _host(env._sites_soa(q, fr))
    qh, = _host(q)
    # geom order fixed by _build_model: palm, (prox, tip) x 3 digits,
    # handle a/b, panel a/b
    DIGITS = ((1, 2), (3, 4), (5, 6))
    H_A, H_B, D_B = 7, 8, 10

    def draw(ax, t):
        p = pts[t]
        palm = p[env._palm_geom]
        # arm chain (top-down, x-y plane)
        xs = list(pos[t, :4, 0]) + [float(palm[0])]
        ys = list(pos[t, :4, 1]) + [float(palm[1])]
        ax.plot(xs, ys, "o-", lw=3, color="C0")
        # digits: palm -> proximal -> tip
        for prox, tip in DIGITS:
            ax.plot([palm[0], p[prox, 0], p[tip, 0]],
                    [palm[1], p[prox, 1], p[tip, 1]],
                    "o-", lw=1.5, ms=3, color="C2")
        # door panel: hinge to far panel sphere
        hinge = pos[t, DOOR, :2]
        ax.plot([hinge[0], p[D_B, 0]], [hinge[1], p[D_B, 1]],
                lw=5, color="C1")
        # handle bar
        ax.plot([p[H_A, 0], p[H_B, 0]], [p[H_A, 1], p[H_B, 1]],
                lw=3, color="C3")
        ax.set_title(f"door={qh[t, DOOR]:.2f} latch={qh[t, LATCH]:.2f}")

    return _save(path, draw, qh.shape[0], xlim=(-0.3, 1.3),
                 ylim=(-0.9, 0.7), stride=stride)


def render_hammer_hand(env, qpos_history, path, stride=2, board=None,
                       device="cuda"):
    """Side view (x-z) of the grasped-hammer task: arm + fingers, the free
    hammer (handle capsule + head), nail and bench
    (``envs.hammer_hand.HammerHand``). ``board`` is the episode's sampled
    nail-board position (defaults to the nominal scene)."""
    from ppi_tpu_torch.envs.hammer_hand import BENCH_Z, BOARD_POS, NAIL
    q = _history(qpos_history, device)
    bd_t = _vec(board, BOARD_POS, q)
    _, pos = body_frames(env._model, q, NAIL, bd_t)
    pts, = _host(env._sites_soa(q, bd_t))
    qh, bd = _host(q, bd_t)
    # geom order fixed by _build_model: palm, tip_f, tip_a, grip_a,
    # grip_b, head, nail_a, nail_b
    PALM, TIP_F, TIP_A, GRIP_A, GRIP_B, HEAD = range(6)

    def draw(ax, t):
        p = pts[t]
        ax.axhline(BENCH_Z, color="k", lw=1)
        # arm chain (bodies 0-3) to the palm
        xs = list(pos[t, :4, 0]) + [p[PALM, 0]]
        zs = list(pos[t, :4, 2]) + [p[PALM, 2]]
        ax.plot(xs, zs, "o-", lw=3, color="C0", ms=4)
        # fingers: knuckle (body origin) -> tip
        for body, tip in ((4, TIP_F), (5, TIP_A)):
            ax.plot([pos[t, body, 0], p[tip, 0]],
                    [pos[t, body, 2], p[tip, 2]], "o-", lw=1.5, ms=3,
                    color="C2")
        # hammer: handle from grip_a through head, head as a fat marker
        ax.plot([p[GRIP_A, 0], p[HEAD, 0]],
                [p[GRIP_A, 2], p[HEAD, 2]], lw=4, color="C1")
        ax.plot([p[HEAD, 0]], [p[HEAD, 2]], "s", ms=12, color="C1")
        # nail: a vertical pin on the (sampled) board sinking with depth
        depth = qh[t, NAIL]
        ax.plot([bd[0], bd[0]], [bd[2] - 0.01, bd[2] + 0.06 - depth],
                lw=3, color="C3")
        ax.set_title(f"nail depth={depth:.3f}")

    return _save(path, draw, qh.shape[0], xlim=(-0.2, 1.1),
                 ylim=(0.35, 1.25), stride=stride)


def render_planar(env, qpos_history, path, stride=2, xlim=None,
                  device="cuda"):
    """Side view (x-z) of a planar locomotor (cheetah/hopper)."""
    q = _history(qpos_history, device)
    _, pos = body_frames(env._model, q)
    qh, = _host(q)
    x_final = float(qh[-1, 0])
    if xlim is None:
        xlim = (min(-1.0, x_final - 1), max(2.0, x_final + 1))
    parents = env._model.parents

    def draw(ax, t):
        ax.axhline(0.0, color="k", lw=1)
        # draw each chain from torso through children by parent links
        for b in range(len(parents)):
            p = parents[b]
            if p >= 0:
                ax.plot([pos[t, p, 0], pos[t, b, 0]],
                        [pos[t, p, 2], pos[t, b, 2]],
                        "o-", lw=3, color="C0", ms=4)
        ax.set_title(f"x={qh[t, 0]:.2f}")

    return _save(path, draw, qh.shape[0], xlim=xlim, ylim=(-0.2, 2.0),
                 stride=stride)


def render_ball_in_a_cup(sim, qpos_history, particles_history, path,
                         stride=4, device="cuda"):
    """Side view (x-z) of the WAM + string + ball + cup."""
    q = _history(qpos_history, device)
    _, pos = body_frames(sim._model, q)
    bottom, top, up = _host(*sim.cup_frame(q))
    qh, = _host(q)
    parts = (particles_history.detach().cpu().numpy()
             if isinstance(particles_history, torch.Tensor)
             else np.asarray(particles_history))

    def draw(ax, t):
        ax.plot(pos[t, :, 0], pos[t, :, 2], "o-", lw=4, color="C0", ms=5)
        b, tp = bottom[t], top[t]
        ax.plot([pos[t, -1, 0], b[0]], [pos[t, -1, 2], b[2]], lw=3,
                color="C0")
        # cup as a U: two wall lines
        side = np.cross(up[t], [0, 1, 0])[[0, 2]]
        r = 0.0345
        for s in (-1, 1):
            ax.plot([b[0] + s * r * side[0], tp[0] + s * r * side[0]],
                    [b[2] + s * r * side[1], tp[2] + s * r * side[1]],
                    lw=2, color="C1")
        ax.plot([b[0] - r * side[0], b[0] + r * side[0]],
                [b[2] - r * side[1], b[2] + r * side[1]],
                lw=2, color="C1")
        ax.plot(parts[t, :, 0], parts[t, :, 2], "-", lw=1, color="gray")
        ax.plot(parts[t, -1, 0], parts[t, -1, 2], "o", ms=8, color="C3")

    return _save(path, draw, qh.shape[0], xlim=(-0.6, 1.0),
                 ylim=(0.6, 2.4), stride=stride)


def trace_bic_trajectory(sim, q0, qs, qds):
    """Run a ball-in-a-cup trajectory recording (qpos, particles) a step:
    ``q0`` (4,), setpoints ``qs``, ``qds`` (T, 4) (numpy or tensors).
    Returns (qpos (T + cool-down, 4), particles (T + cool-down, P+1, 3),
    final ``BicState``), on ``q0``'s device (the CPU for numpy): the
    trajectory and cool-down phases' history, as JAX's trace returns.

    The scalar program runs at one lane on the host over
    ``numpy.float32`` scalars: stabilize, the statistics cleared (as
    ``execute_trajectory`` and the kernel clear them; JAX's trace does
    not, so its final statistics also count the stabilize phase), the
    trajectory, the cool-down. Its final state is what one launch of the
    ball-in-a-cup kernel computes for these setpoints."""
    dev = q0.device if isinstance(q0, torch.Tensor) else torch.device("cpu")
    host = lambda x: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x)).astype(np.float32)
    q0, qs, qds = host(q0), host(qs), host(qds)
    L, n_pts = sim.layout, sim.layout.n_points
    row = lambda v: tuple(np.float32(x) for x in v)
    s = tuple(np.float32(x) for x in sim.reset_soa(row(q0)))
    hold, still = row(q0), row(np.zeros(4, np.float32))
    for _ in range(sim.stabilize_steps):
        s = sim.step_soa(s, hold, still)
    s = list(s)
    s[L.MAX_POT] = np.float32(-math.inf)
    for k in (L.SUM_VEL, L.SUM_POS, L.SUM_BALL, L.N_STEPS):
        s[k] = np.float32(0.0)
    s[L.Q0:L.Q0 + 4] = s[L.Q:L.Q + 4]
    s = tuple(s)
    steps = [(row(a), row(b)) for a, b in zip(qs, qds)]
    steps += [(row(qs[-1]), still)] * sim.cooldown_steps
    record = np.empty((len(steps), 4 + 3 * n_pts), np.float32)
    for k, (q_des, qd_des) in enumerate(steps):
        s = sim.step_soa(s, q_des, qd_des)
        record[k] = s[L.Q:L.Q + 4] + s[L.PARTICLES:L.PARTICLES + 3 * n_pts]
    hist = torch.from_numpy(record).to(dev)
    final = torch.tensor(np.asarray(s, np.float32), device=dev)
    t = torch.tensor(sim.stabilize_steps + len(steps), dtype=torch.int32,
                     device=dev)
    return (hist[:, :4], hist[:, 4:].reshape(-1, n_pts, 3),
            sim.state_of(tuple(final.unbind(-1)), t))


def render_relocate(env, qpos_history, path, stride=2, target=None,
                    device="cuda"):
    """Side view (x-z) of the relocate task: arm, caging fingers, free ball,
    in-air target. ``target`` is the episode's sampled goal (defaults to
    the env's ``target``)."""
    from ppi_tpu_torch.envs.relocate import BALL_RADIUS, TABLE_Z
    q = _history(qpos_history, device)
    _, pos = body_frames(env._model, q)
    pts, = _host(env._sites_soa(q))
    qh, = _host(q)
    target = _host(_vec(target, getattr(env, "target", None), q))[0]

    def draw(ax, t):
        p = pts[t]
        ax.axhline(TABLE_Z, color="k", lw=1)
        # arm chain (x-z)
        palm = p[0]
        xs = list(pos[t, :4, 0]) + [float(palm[0])]
        zs = list(pos[t, :4, 2]) + [float(palm[2])]
        ax.plot(xs, zs, "o-", lw=3, color="C0", ms=4)
        # fingers: knuckle -> fork tips
        for knuckle, tips in ((4, (1, 2)), (5, (3, 4))):
            for tip in tips:
                ax.plot([pos[t, knuckle, 0], p[tip][0]],
                        [pos[t, knuckle, 2], p[tip][2]], "-", lw=2,
                        color="C2")
        ball = p[5]
        circ = np.linspace(0, 2 * np.pi, 24)
        ax.plot(ball[0] + BALL_RADIUS * np.cos(circ),
                ball[2] + BALL_RADIUS * np.sin(circ), color="C3")
        ax.plot(target[0], target[2], "*", ms=14, color="C1")
        dist = np.linalg.norm(ball - target)
        ax.set_title(f"ball-target {dist:.3f} m")

    return _save(path, draw, qh.shape[0], xlim=(-0.2, 1.1),
                 ylim=(0.3, 1.4), stride=stride)


def render_pen(env, qpos_history, path, stride=2, target=None,
               device="cuda"):
    """Top/side two-projection schematic of the pen task: rod, fingertips,
    target orientation ray. ``target`` is the episode's sampled goal axis
    (defaults to the fixed ``pen.target_axis()``)."""
    from ppi_tpu_torch.envs.pen import HOLD_POS, PEN_HALF, target_axis
    hold = np.asarray(HOLD_POS)
    q = _history(qpos_history, device)
    pts, = _host(env._sites_soa(q))
    qh, = _host(q)
    tgt = _host(_vec(target, target_axis(), q))[0]

    def draw(ax, t):
        ea, eb = pts[t, 0], pts[t, 1]
        tip_a, tip_b = pts[t, 2], pts[t, 3]
        # side view (x-z), centred on the hold point
        ax.plot([ea[0], eb[0]], [ea[2], eb[2]], "-", lw=4, color="C0")
        ax.plot([tip_a[0]], [tip_a[2]], "o", ms=8, color="C2")
        ax.plot([tip_b[0]], [tip_b[2]], "o", ms=8, color="C2")
        ray = np.stack([hold - PEN_HALF * tgt, hold + PEN_HALF * tgt])
        ax.plot(ray[:, 0], ray[:, 2], "--", lw=2, color="C1")
        axis = (ea - eb) / (np.linalg.norm(ea - eb) + 1e-9)
        ax.set_title(f"similarity {float(axis @ tgt):.3f}")

    return _save(path, draw, qh.shape[0],
                 xlim=(hold[0] - 0.2, hold[0] + 0.2),
                 ylim=(hold[2] - 0.2, hold[2] + 0.2), stride=stride)


def render_pen_hand(env, qpos_history, path, stride=2, target=None,
                    device="cuda"):
    """Side-view (x-z projection at the hold) schematic of the pen-hand
    task: rod, three articulated digits, target orientation ray
    (``envs.pen_hand.PenHand``). The x-z plane shows the pen's long axis
    and the goal ray; digit curl (a y-z motion about the x hinges) is
    foreshortened in this view."""
    from ppi_tpu_torch.envs.pen import HOLD_POS, PEN_HALF, target_axis
    hold = np.asarray(HOLD_POS)
    q = _history(qpos_history, device)
    _, pos = body_frames(env._model, q)
    pts, = _host(env._sites_soa(q))
    qh, = _host(q)
    tgt = _host(_vec(target, target_axis(), q))[0]
    # body order: 5 pen dofs, then (mcp, pip) x (A, B, thumb)
    DIGIT_BODIES = ((5, 6), (7, 8), (9, 10))
    # geom order: end_a, end_b, then (prox, tip) x 3
    DIGIT_GEOMS = ((2, 3), (4, 5), (6, 7))

    def draw(ax, t):
        p = pts[t]
        ea, eb = p[0], p[1]
        # x-z projection: rod + target ray
        ax.plot([ea[0], eb[0]], [ea[2], eb[2]], "-", lw=4, color="C0")
        ray = np.stack([hold - PEN_HALF * tgt, hold + PEN_HALF * tgt])
        ax.plot(ray[:, 0], ray[:, 2], "--", lw=2, color="C1")
        for (mcp, _), (prox_g, tip_g) in zip(DIGIT_BODIES, DIGIT_GEOMS):
            mount = pos[t, mcp]
            ax.plot([mount[0], p[prox_g, 0], p[tip_g, 0]],
                    [mount[2], p[prox_g, 2], p[tip_g, 2]],
                    "o-", lw=1.5, ms=3, color="C2")
        axis = (ea - eb) / (np.linalg.norm(ea - eb) + 1e-9)
        ax.set_title(f"similarity {float(axis @ tgt):.3f}")

    return _save(path, draw, qh.shape[0],
                 xlim=(hold[0] - 0.22, hold[0] + 0.22),
                 ylim=(hold[2] - 0.22, hold[2] + 0.22), stride=stride)


def render_relocate_hand(env, qpos_history, path, stride=2, target=None,
                         device="cuda"):
    """Side view (x-z) of the relocate-hand task: arm, three digits, free
    ball, in-air target (``envs.relocate_hand.RelocateHand``)."""
    from ppi_tpu_torch.envs.relocate import BALL_RADIUS, TABLE_Z
    q = _history(qpos_history, device)
    _, pos = body_frames(env._model, q)
    pts, = _host(env._sites_soa(q))
    qh, = _host(q)
    tgt = _host(_vec(target, getattr(env, "target", None), q))[0]
    # geom order: palm, (prox, tip) x 3 digits, ball
    DIGITS = ((1, 2), (3, 4), (5, 6))
    BALL = 7

    def draw(ax, t):
        p = pts[t]
        ax.axhline(TABLE_Z, color="k", lw=1)
        palm = p[0]
        xs = list(pos[t, :4, 0]) + [float(palm[0])]
        zs = list(pos[t, :4, 2]) + [float(palm[2])]
        ax.plot(xs, zs, "o-", lw=3, color="C0", ms=4)
        for prox, tip in DIGITS:
            ax.plot([palm[0], p[prox, 0], p[tip, 0]],
                    [palm[2], p[prox, 2], p[tip, 2]],
                    "o-", lw=1.5, ms=3, color="C2")
        ball = p[BALL]
        circ = np.linspace(0, 2 * np.pi, 24)
        ax.plot(ball[0] + BALL_RADIUS * np.cos(circ),
                ball[2] + BALL_RADIUS * np.sin(circ), color="C3")
        ax.plot(tgt[0], tgt[2], "*", ms=14, color="C1")
        dist = np.linalg.norm(ball - tgt)
        ax.set_title(f"ball-target {dist:.3f} m")

    return _save(path, draw, qh.shape[0], xlim=(-0.2, 1.1),
                 ylim=(0.3, 1.4), stride=stride)
