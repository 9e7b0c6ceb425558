"""Mesh-level 3-D episode rendering: an analytic ray-caster in torch.

Port of ``ppi_tpu/render3d.py``. The scenes' collision geometry (every
sphere geom at its FK pose, a capsule a kinematic link from the parent's
joint origin to the child's, the model's contact planes) is ray-cast in
closed form (ray/sphere, ray/capsule, ray/plane), Lambert-shaded with a
hard shadow ray and a checkered ground: the JAX package's per-pixel
program, batched over a chunk of frames and every pixel at once.

The kinematics come from the scalar program: ``make_body_frames_soa``
over the episode's frames as lanes (the JAX package calls its tensor
engine's ``fk``, which the port does not have). ``dyn_body``/``dyn_pos``
substitute that body's joint-origin offset, as
``engine_soa.make_sites_soa`` does.

Every dot product is an elementwise multiply-and-sum, never a matmul, so
no path reaches TF32 whatever ``torch.set_float32_matmul_precision``
says (the JAX package pins its matmuls to "highest": bf16 turned the FK
chains into speckle). The frames render in chunks sized so that the
per-pixel intermediates of a chunk stay under ``MEMORY_BUDGET`` bytes.
"""

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch.envs.physics.engine_soa import make_body_frames_soa
from ppi_tpu_torch.utils.video import save_gif

_BIG = 1e9
_EPS = 1e-6
# the (frames, pixels, primitives) tensors a chunk keeps alive at once,
# at most (the capsule test's), for sizing chunks against a budget
_LIVE = 24
MEMORY_BUDGET = 2 << 30

# a small qualitative palette (colorblind-safe Okabe-Ito values), cycled
# over bodies so digits/links are distinguishable in the gif
_PALETTE = np.array([
    [0.35, 0.55, 0.85],
    [0.90, 0.62, 0.17],
    [0.22, 0.65, 0.45],
    [0.80, 0.45, 0.66],
    [0.55, 0.45, 0.80],
    [0.85, 0.37, 0.31],
], dtype=np.float32)


@dataclass(frozen=True)
class Camera:
    eye: tuple = (1.6, -1.4, 1.9)
    target: tuple = (0.3, 0.0, 0.9)
    up: tuple = (0.0, 0.0, 1.0)
    fov_deg: float = 40.0
    width: int = 320
    height: int = 240


@dataclass(frozen=True)
class SceneStyle:
    link_radius: float = 0.016
    light_dir: tuple = (-0.45, 0.35, 0.82)  # TOWARD the light
    ambient: float = 0.35
    background: tuple = (0.93, 0.95, 0.98)
    checker: float = 0.25  # checker tile size (m); 0 disables
    floor: float | None = None  # add a z=floor ground when the model has
    #                             no plane geom (visual only, no contact)
    sphere_colors: dict = field(default_factory=dict)  # geom idx -> rgb


def scene_arrays(model, style: SceneStyle | None = None):
    """Static (host-side) scene description: capsule topology + colors.

    Returns (link_pairs (nl, 2) body ids, sphere_colors (ns, 3),
    link_color (3,)). Capsules connect each body's joint origin to its
    parent's; zero-length links (stacked joints) are dropped.
    """
    style = style or SceneStyle()
    parents = model.parents
    offs = np.asarray(model.offset_pos)
    pairs = [(p, b) for b, p in enumerate(parents)
             if p >= 0 and np.linalg.norm(offs[b]) > 1e-4]
    sphere_body = np.asarray(model.sphere_body)
    colors = _PALETTE[sphere_body % len(_PALETTE)].copy()
    for idx, rgb in style.sphere_colors.items():
        colors[idx] = rgb
    return (np.asarray(pairs, np.int32).reshape(-1, 2), colors,
            np.array([0.62, 0.64, 0.68], np.float32))


# ---- vectors as (x, y, z) triples of tensors ---------------------------------
# The ray-caster keeps each vector's components apart: a dot product is
# two elementwise adds of three products (the order of a length-3 sum), and
# no (..., 3) matmul is ever formed.

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _lanes(v, dim):
    """(..., 3) -> three tensors, each with a new axis at ``dim``."""
    return tuple(c.unsqueeze(dim) for c in v.unbind(-1))


def _ray_spheres(ro, rd, centers, radii):
    """Nearest-hit t of each ray against each sphere; _BIG for a miss.
    ``ro``, ``rd``: components (F, P, 1); ``centers``: (F, 1, ns);
    ``radii``: (ns,). Returns (F, P, ns)."""
    oc = _sub(ro, centers)
    b = _dot(oc, rd)
    c = _dot(oc, oc) - radii ** 2
    h = b * b - c
    t = -b - torch.sqrt(torch.clamp(h, min=0.0))
    return torch.where((h > 0) & (t > _EPS), t, _BIG)


def _ray_capsules(ro, rd, a, b, r):
    """Nearest-hit t against each capsule (iq's closed form); ``a``, ``b``
    components (F, 1, nc). Returns (F, P, nc)."""
    ba = _sub(b, a)
    oa = _sub(ro, a)
    baba = _dot(ba, ba)
    bard = _dot(ba, rd)
    baoa = _dot(ba, oa)
    rdoa = _dot(oa, rd)
    oaoa = _dot(oa, oa)
    k2 = baba - bard ** 2
    k1 = baba * rdoa - baoa * bard
    k0 = baba * (oaoa - r ** 2) - baoa ** 2
    h = k1 * k1 - k2 * k0
    t_cyl = (-k1 - torch.sqrt(torch.clamp(h, min=0.0))) / torch.where(
        torch.abs(k2) > _EPS, k2, _EPS)
    y = baoa + t_cyl * bard
    cyl_ok = (h > 0) & (t_cyl > _EPS) & (y > 0) & (y < baba)
    # end caps: sphere at a (y <= 0) or b (y >= baba)
    first = y <= 0
    oc = _sub(ro, tuple(torch.where(first, ca, cb) for ca, cb in zip(a, b)))
    cb_ = _dot(oc, rd)
    cc = _dot(oc, oc) - r ** 2
    ch = cb_ * cb_ - cc
    t_cap = -cb_ - torch.sqrt(torch.clamp(ch, min=0.0))
    cap_ok = (ch > 0) & (t_cap > _EPS)
    return torch.where(cyl_ok, t_cyl, torch.where(cap_ok, t_cap, _BIG))


def _ray_planes(ro, rd, normals, offsets):
    """``normals`` components (1, 1, np), ``offsets`` (np,)."""
    denom = _dot(normals, rd)
    t = (offsets - _dot(normals, ro)) / torch.where(
        torch.abs(denom) > _EPS, denom, _EPS)
    return torch.where((torch.abs(denom) > _EPS) & (t > _EPS), t, _BIG)


def _take(v, i):
    """Component-wise gather along the primitive axis: ``v`` (F, 1, n)
    triples, ``i`` (F, P) -> (F, P) triples."""
    return tuple(torch.gather(c.expand(c.shape[0], i.shape[1], c.shape[2]),
                              2, i.unsqueeze(-1)).squeeze(-1) for c in v)


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _shade(ro, rd, geo, light, ambient, bg, checker):
    """(F, P, 3) colours of the rays ``ro`` + t ``rd`` (components
    (F, P, 1)) against the frames' primitives ``geo``."""
    ns, nc = geo["sc"][0].shape[-1], geo["ca"][0].shape[-1]
    npl = geo["pn"][0].shape[-1]
    ts = _ray_spheres(ro, rd, geo["sc"], geo["sr"])
    tc = _ray_capsules(ro, rd, geo["ca"], geo["cb"], geo["cr"])
    tp = _ray_planes(ro, rd, geo["pn"], geo["po"])
    all_t = torch.cat([ts, tc, tp], -1)
    del ts, tc, tp
    t, i = torch.min(all_t, -1)
    del all_t
    # torch.min's index is the first minimum's (jnp.argmin's)
    hit = t < _BIG
    ro, rd = tuple(c.squeeze(-1) for c in ro), tuple(c.squeeze(-1)
                                                       for c in rd)
    p = tuple(o + t * d for o, d in zip(ro, rd))

    is_s = i < ns
    is_c = (i >= ns) & (i < ns + nc)
    si = torch.clamp(i, 0, ns - 1)
    ci = torch.clamp(i - ns, 0, max(nc - 1, 0))
    pi = torch.clamp(i - ns - nc, 0, npl - 1)

    rad = torch.clamp(geo["sr"][si], min=_EPS)
    n_s = tuple(c / rad for c in _sub(p, _take(geo["sc"], si)))
    a, b = _take(geo["ca"], ci), _take(geo["cb"], ci)
    ba = _sub(b, a)
    y = torch.clamp(_dot(_sub(p, a), ba)
                    / torch.clamp(_dot(ba, ba), min=_EPS), 0.0, 1.0)
    n_c = tuple(pc - (ac + y * bc) for pc, ac, bc in zip(p, a, ba))
    len_c = torch.clamp(_norm(n_c), min=_EPS)
    n_c = tuple(c / len_c for c in n_c)
    n_p = tuple(c.reshape(-1)[pi] for c in geo["pn"])
    n = tuple(torch.where(is_s, s_, torch.where(is_c, c_, p_))
              for s_, c_, p_ in zip(n_s, n_c, n_p))
    len_n = torch.clamp(_norm(n), min=_EPS)
    n = tuple(c / len_n for c in n)

    # checkerboard on planes
    if checker > 0:
        tile = max(checker, _EPS)
        chk = 0.82 + 0.13 * torch.remainder(
            torch.floor(p[0] / tile) + torch.floor(p[1] / tile), 2.0)
    else:
        chk = torch.full_like(p[0], 0.9)
    scol = geo["scol"][si]                               # (F, P, 3)
    color = torch.where(is_s.unsqueeze(-1), scol, torch.where(
        is_c.unsqueeze(-1), geo["ccol"], chk.unsqueeze(-1)))

    # hard shadow: any hit toward the light (planes can't shadow)
    so = tuple((o + 1e-3 * nn).unsqueeze(-1) for o, nn in zip(p, n))
    lr = tuple(torch.full_like(so[0], float(c)) for c in light)
    shadow = torch.minimum(
        torch.min(_ray_spheres(so, lr, geo["sc"], geo["sr"]), -1).values,
        torch.min(_ray_capsules(so, lr, geo["ca"], geo["cb"], geo["cr"]),
                  -1).values) < _BIG
    diff = torch.clamp(n[0] * light[0] + n[1] * light[1] + n[2] * light[2],
                       min=0.0)
    diff = torch.where(shadow, 0.15 * diff, diff)
    shade = ambient + (1.0 - ambient) * diff
    rgb = torch.clamp(color * shade.unsqueeze(-1), 0.0, 1.0)
    return torch.where(hit.unsqueeze(-1), rgb, bg)


def _world_geo(model, rot, pos, link_pairs, sphere_colors, link_color,
               link_radius, floor, device):
    """The frames' world-space primitives from FK ``rot`` (F, nb, 3, 3),
    ``pos`` (F, nb, 3): each vector a triple of (F, 1, n) components."""
    sb = torch.as_tensor(np.asarray(model.sphere_body), dtype=torch.long,
                         device=device)
    sp = torch.as_tensor(np.asarray(model.sphere_pos), device=device)
    r, p = rot[:, sb], pos[:, sb]                        # (F, ns, 3, 3)
    sc = tuple(p[..., k] + (r[..., k, 0] * sp[:, 0] + r[..., k, 1]
                            * sp[:, 1] + r[..., k, 2] * sp[:, 2])
               for k in range(3))
    f = pos.shape[0]
    if link_pairs.shape[0]:
        lp = torch.as_tensor(link_pairs, dtype=torch.long, device=device)
        ca, cb = pos[:, lp[:, 0]], pos[:, lp[:, 1]]
    else:
        # degenerate far-away capsule: keeps every gather in _shade valid
        ca = torch.full((f, 1, 3), -2.0 * _BIG, device=device)
        cb = ca + 1.0
    if model.plane_normal.shape[0]:
        pn, po = np.asarray(model.plane_normal), np.asarray(
            model.plane_offset)
    elif floor is not None:
        pn, po = np.array([[0.0, 0.0, 1.0]]), np.array([float(floor)])
    else:
        # far-below dummy plane: its hit t (~1e12) exceeds the miss
        # sentinel so it never wins the z-test nor registers as a hit
        pn, po = np.array([[0.0, 0.0, 1.0]]), np.array([-1000.0 * _BIG])
    as_f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                       device=device)
    pn = as_f32(pn)
    return {
        "sc": tuple(c.unsqueeze(1) for c in sc),
        "sr": as_f32(model.sphere_radius),
        "ca": _lanes(ca, 1), "cb": _lanes(cb, 1),
        "cr": as_f32(link_radius),
        "pn": tuple(c.reshape(1, 1, -1) for c in pn.unbind(-1)),
        "po": as_f32(po),
        "scol": as_f32(sphere_colors), "ccol": as_f32(link_color),
    }


def _rays(camera: Camera):
    eye = np.asarray(camera.eye, np.float32)
    fwd = np.asarray(camera.target, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(camera.up, np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    h, w = camera.height, camera.width
    tanf = np.tan(np.radians(camera.fov_deg) / 2)
    xs = (np.arange(w) + 0.5) / w * 2 - 1
    ys = 1 - (np.arange(h) + 0.5) / h * 2
    px, py = np.meshgrid(xs * tanf * w / h, ys * tanf)
    dirs = (fwd[None, None] + px[..., None] * right[None, None]
            + py[..., None] * up[None, None])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return eye, dirs.reshape(-1, 3).astype(np.float32)


def frames_per_chunk(model, camera: Camera, link_pairs) -> int:
    """How many frames one chunk renders: ``_LIVE`` f32 tensors of
    (frames, pixels, primitives) within ``MEMORY_BUDGET`` bytes."""
    n_prim = (len(model.sphere_body) + max(len(link_pairs), 1)
              + max(model.plane_normal.shape[0], 1))
    per_frame = _LIVE * 4 * camera.width * camera.height * n_prim
    return max(1, int(MEMORY_BUDGET // per_frame))


def render_trajectory(env, qpos_traj, camera: Camera | None = None,
                      style: SceneStyle | None = None, dyn_pos=None,
                      stride: int = 1, device="cuda"):
    """Ray-cast an episode's qpos history into (T, H, W, 3) uint8 frames.

    ``env`` is any physics env exposing ``_model``; ``dyn_pos`` is the
    per-episode dynamic-body position (e.g. the sampled board) for envs
    with a ``scalar_dyn_body``. A tensor history renders on its device; a
    numpy one on ``device`` (the card unless the caller names another).
    """
    camera = camera or Camera()
    style = style or SceneStyle()
    model = env._model
    if isinstance(qpos_traj, torch.Tensor):
        device = qpos_traj.device
    qpos = torch.as_tensor(qpos_traj if isinstance(qpos_traj, torch.Tensor)
                           else np.asarray(qpos_traj), dtype=torch.float32,
                           device=device)[::stride]
    link_pairs, sphere_colors, link_color = scene_arrays(model, style)
    dyn_body = getattr(env, "scalar_dyn_body", None)
    body_pos = None
    if dyn_body is not None and dyn_pos is not None:
        body_pos = (dyn_pos.to(device, torch.float32)
                    if isinstance(dyn_pos, torch.Tensor)
                    else torch.as_tensor(np.asarray(dyn_pos, np.float32),
                                         device=device))
    else:
        dyn_body = None
    rot, pos = make_body_frames_soa(model, dyn_body=dyn_body)(qpos, body_pos)

    eye, dirs = _rays(camera)
    rd = _lanes(torch.as_tensor(dirs, device=device)[None], -1)
    ro = tuple(torch.full_like(rd[0], float(c)) for c in eye)
    light = torch.as_tensor(np.asarray(style.light_dir, np.float32))
    light = (light / torch.sqrt(_dot(light, light))).tolist()
    bg = torch.as_tensor(np.asarray(style.background, np.float32),
                         device=device)
    chunk = frames_per_chunk(model, camera, link_pairs)
    out = []
    for k in range(0, qpos.shape[0], chunk):
        geo = _world_geo(model, rot[k:k + chunk], pos[k:k + chunk],
                         link_pairs, sphere_colors, link_color,
                         style.link_radius, style.floor, device)
        f = geo["sc"][0].shape[0]
        img = _shade(tuple(c.expand(f, -1, -1) for c in ro),
                     tuple(c.expand(f, -1, -1) for c in rd), geo, light,
                     style.ambient, bg, style.checker)
        out.append(torch.round(img * 255).to(torch.uint8).reshape(
            f, camera.height, camera.width, 3))
    return torch.cat(out).cpu().numpy()


def save_gif_3d(path, env, qpos_traj, camera: Camera | None = None,
                style: SceneStyle | None = None, dyn_pos=None,
                fps: int = 25, stride: int = 1, device="cuda"):
    """Render + write an episode GIF; returns the written path."""
    frames = render_trajectory(env, qpos_traj, camera=camera, style=style,
                               dyn_pos=dyn_pos, stride=stride, device=device)
    return save_gif(Path(path), list(frames), fps=fps)
