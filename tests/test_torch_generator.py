"""The code generator of the rollout kernel's per-env body.

The generated header and the hand-written skeleton (csrc/rollout.cu) also
compile as host C; where a C compiler exists, that build is run through
ctypes against the plain version, which checks the generator before any
GPU run.
"""

import hashlib
import math
import re
import shutil

import numpy as np
import pytest
import torch

from torch_helpers import door_clamp, door_q0, to_np, to_torch
from ppi_tpu_torch.envs.door import DOOR, Door
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    body_args, generate_env_header, load_host_rollout, ops_per_lane_step,
    plain_rollout)
from ppi_tpu_torch.runners.run_mpc import ENVS


def _header(door, project_fn=None):
    return generate_env_header(door._model, door.dt, door.substeps,
                               door.action_dim, door.scalar_torque,
                               door.scalar_reward, door.scalar_dyn_body,
                               project_fn=project_fn)


# sha256 of each body without a projection, as generated before the
# projection hook existed: an env without ``scalar_project`` gets the same
# text (only the skeleton's build hash changes)
HEADER_SHA256 = {
    "door-v0": "b62f952e40ddbc029f3f12d0b0aa80511a849ddf2c4d920644e618fc3d59be45",
    "pen-v0": "c95274b997773768c720bd5cba16d5332f6f749e1ff78f34f232ebe1ed78fe0f",
    "relocate-v0":
        "bfb0f6b063543a54597a9d5d730cfb18dc52318407ce312a1a7561e61ff108d9",
    "cheetah": "fdab3b100229171aa3c47584dac0833a894a9b0d36a5b37ff6de8ebefb0809df",
}


@pytest.mark.parametrize("name", sorted(HEADER_SHA256))
def test_bodies_without_a_projection_are_unchanged(name):
    env = ENVS[name]()
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    header = generate_env_header(*body_args(env, state))
    assert "PPI_PROJECT" not in header and "env_project" not in header
    assert hashlib.sha256(header.encode()).hexdigest() == HEADER_SHA256[name]


# ... and of the two bodies with the projection, as first generated: a new
# env adds its own body and changes no other
PROJECTED_SHA256 = {
    "door-v0-hand":
        "9de049e5cddac6722b1761ba97f2d4d99cd6785df28d177259f8e8addd02023d",
    "door-v0-adroit":
        "4c513149720388b3c6b2868c862765da0b95a419de74bcc3413d1455ac6de4fb",
}


@pytest.mark.parametrize("name", sorted(PROJECTED_SHA256))
def test_bodies_with_a_projection_are_unchanged(name):
    env = ENVS[name]()
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    header = generate_env_header(*body_args(env, state))
    assert "#define PPI_PROJECT 1" in header
    assert hashlib.sha256(header.encode()).hexdigest() == \
        PROJECTED_SHA256[name]


# ... and of the variant-(b) bodies as first generated, with the sha256 of
# the hand-written skeleton they all build into: a new env adds a body and
# changes neither the skeleton nor another body
SKELETON_SHA256 = \
    "734122d28245ef80132f6d5bb094d450140a4a081e5dd8d86b7195a81b80a18d"
VARIANT_B_SHA256 = {
    "reacher":
        "76f23b5f229f67609beb0b55d18a270bf1b79ca211a342a34b08e6e1f4b29b93",
    "finger~spin":
        "ea2338f030a6ab55c0b1672a7ca60e5ac2f61e387d2d8c0794d33e5690267bb9",
    "fetch-push":
        "0395b34a0039df0a6cc3cfc1bec6340331c7caec15005cecd08e640a588d13a1",
    "fetch-pick":
        "768bc67b786da18e94d666c89d53501bebd90848524314cc7b19bc9162be6a3a",
    "hopper":
        "fa3e33da08acc153ae9bdb65218458892474d52eb9ffb0500e6b2f45e1b8b4c8",
    "walker2d":
        "1b0a48cc6720399e0e5380e77e20434845094fb701ce6ed91312505c2b93705b",
    "walker~walk":
        "b78f601c8dc7bb4a090c895ac5656d741c0a5c695d8cc5523ede357708a3277a",
    "humanoid-standup":
        "a826189e4a07dd7db2d980a3224f7cbcafd2f92ee1ac12658bebb2db661985fb",
}


def test_the_skeleton_is_unchanged():
    from ppi_tpu_torch.build import CSRC
    text = (CSRC / "rollout.cu").read_bytes()
    assert hashlib.sha256(text).hexdigest() == SKELETON_SHA256


# ... and of hammer-v0, the three 3-digit hand bodies and the three Adroit
# bodies, as first generated: the Adroit envs subclass the 3-digit ones,
# whose bodies their generalization leaves byte for byte as they were
SCENE_SHA256 = {
    "hammer-v0":
        "f1ebacf35e426d442b9290b024ed458c54106efa208e4561725abb860fbc65ef",
    "pen-v0-hand":
        "d84f5affcf0cad6d831962c4ab3c77cbf2be9cfd2a96883fc7a599c352c7fd03",
    "relocate-v0-hand":
        "8ba9089cdf3f99a00051f13dee0ac77476928cb4a9a1eb8228e0e2f030d893cd",
    "hammer-v0-hand":
        "90facf7af8f7d6053e9a5c3d826fcd1b5eb676cef066963a3f1125d870f0448a",
    "pen-v0-adroit":
        "631241ea92bece21db36f038f9b985f9e94874c221e2d630bd2e23d8a1854045",
    "relocate-v0-adroit":
        "7b82f77fa397a13b538bd642f026a03e705ed19cbb9c8066580f2ae7426df96a",
    "hammer-v0-adroit":
        "20feced26fb63cfd481f1cb7cbbe137aef8579f3003b78ceb24f4a450afbf1e9",
}


@pytest.mark.parametrize("name", sorted(SCENE_SHA256))
def test_scene_bodies_are_unchanged(name):
    env = ENVS[name]()
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    header = generate_env_header(*body_args(env, state))
    assert "PPI_PROJECT" not in header
    assert hashlib.sha256(header.encode()).hexdigest() == \
        SCENE_SHA256[name]


@pytest.mark.parametrize("name", sorted(VARIANT_B_SHA256))
def test_variant_b_bodies_are_unchanged(name):
    env = ENVS[name]()
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    header = generate_env_header(*body_args(env, state))
    assert "PPI_PROJECT" not in header
    assert hashlib.sha256(header.encode()).hexdigest() == \
        VARIANT_B_SHA256[name]
    # walker~walk's tolerance is the first exp in a body, hopper's and the
    # walker's healthy gate the first fabs
    calls = set(re.findall(r"= ([a-z_]+)\(", header))
    assert ("expf" in calls) == (name == "walker~walk")
    assert ("fabsf" in calls) == (name in ("hopper", "walker2d"))


def test_projection_emits_its_hook_and_counts_its_ops():
    door = Door()
    header = _header(door, door_clamp)
    assert "#define PPI_PROJECT 1" in header
    body = header.split("void env_project(", 1)[1]
    # only the clamped coordinate and its velocity are written back
    assert re.findall(r"^  (q|qd)\[(\d+)\] =", body, re.M) == [
        ("q", "4"), ("qd", "4")]
    args = (door._model, door.dt, door.substeps, door.action_dim,
            door.scalar_torque, door.scalar_reward, DOOR)
    # two comparisons, their product, a min, two selects
    assert ops_per_lane_step(*args, project_fn=door_clamp) \
        == ops_per_lane_step(*args) + 6


def test_emitted_source_is_deterministic():
    assert _header(Door()) == _header(Door()) == _header(Door(
        fixed_scene=True))


def test_emitted_source_is_single_precision():
    """Every literal is an f32 hex float with an f suffix and every math
    call an f-suffixed one: a bare 0.5 would turn the arithmetic to fp64."""
    body = _header(Door()).split("PPI_QUAL void env_torque", 1)[1]
    for lit in re.findall(r"(?<![\w.])[0-9][0-9a-fA-FxX.pP+\-]*f?", body):
        assert re.fullmatch(r"0x[0-9a-f]\.[0-9a-f]+p[+-]\d+f", lit) or \
            lit.isdigit(), lit  # integers are array indices and defines
    calls = set(re.findall(r"= ([a-z_]+)\(", body))
    assert calls == {"sqrtf", "sinf", "cosf", "ppi_max", "ppi_min",
                     "ppi_gt", "ppi_where", "ppi_sigmoid"}, calls


def test_literals_are_exact_f32():
    for v in (0.1, -1.2, 1e-9, 2e3, 1.0 / 3.0, -0.0):
        lit = sm.f32_literal(v).strip("()").rstrip("f")
        assert np.float32(float.fromhex(lit)) == np.float32(v)
        assert float.fromhex(lit) == float(np.float32(v))
    with pytest.raises(ValueError):
        sm.f32_literal(math.inf)


def test_sym_folds_constants_in_float64_and_keeps_zero_products():
    em = sm.Emitter()
    x = em.input("x", "x_in")
    y = (0.1 * 3.0) * x          # Python folds 0.1 * 3.0 in float64 first
    z = 0.0 * x                  # emitted: a NaN in x must survive
    w = sum([x, x])              # sum() starts from the int 0
    assert y.name != x.name and z.name != x.name
    text = "\n".join(em.lines)
    assert sm.f32_literal(0.1 * 3.0) in text
    assert f"{sm.f32_literal(0.0)} * x" in text
    assert f"{sm.f32_literal(0)} + x" in text and w.name in text
    with pytest.raises(TypeError):
        bool(x)


@pytest.mark.parametrize("fn, x, ref", [
    (sm.sqrt, 2.25, 1.5), (sm.sigmoid, 0.0, 0.5), (sm.sin, 0.0, 0.0),
    (sm.cos, 0.0, 1.0), (lambda v: sm.gt(v, 0.5), 1.0, 1.0),
    (lambda v: sm.gt(v, 0.5), 0.0, 0.0), (sm.abs, -0.75, 0.75),
    (sm.exp, 0.0, 1.0)])
def test_namespace_on_floats_and_tensors(fn, x, ref):
    assert fn(x) == pytest.approx(ref)
    np.testing.assert_allclose(to_np(fn(torch.tensor([x]))), [ref])


@pytest.mark.parametrize("name, c_fn", [("abs", "fabsf"), ("exp", "expf")])
def test_abs_and_exp_emit_their_c_and_match_jnp(name, c_fn):
    """The Sym emits one f-suffixed C call (one op); the float and tensor
    paths match ``jnp.abs`` / ``jnp.exp`` on f32."""
    import jax.numpy as jnp
    fn = getattr(sm, name)
    em = sm.Emitter()
    y = fn(em.input("x", "x_in"))
    assert em.lines[-1] == f"  const float {y.name} = {c_fn}(x);"
    assert em.ops == 1
    x = np.array([-3.5, -1e-3, -0.0, 0.0, 0.7, 2.0, 20.0, np.nan],
                 np.float32)
    ref = np.asarray(getattr(jnp, name)(jnp.asarray(x)))
    np.testing.assert_allclose(to_np(fn(torch.from_numpy(x))), ref,
                               rtol=2e-7, equal_nan=True)
    for v, r in zip(x[:-1], ref[:-1]):
        assert fn(float(v)) == pytest.approx(float(r), rel=1e-6)
    assert isinstance(fn(float(x[0])), float)


def test_namespace_propagates_nan_like_xla():
    t = torch.tensor([np.nan, 1.0])
    assert torch.isnan(sm.maximum(t, 0.0)[0])
    assert torch.isnan(sm.minimum(0.0, t)[0])
    assert torch.isnan(sm.clip(t, -1.0, 1.0)[0])
    np.testing.assert_array_equal(to_np(sm.where(sm.gt(t, 0.0), t, -t)),
                                  [np.nan, 1.0])


@pytest.mark.parametrize("case", ["nominal", "sampled_frame_nan_lane",
                                  "projection"])
def test_host_c_build_matches_plain(case):
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")
    door = Door()
    rng = np.random.default_rng(1)
    n, h = 21, 4
    acts = (0.4 * rng.standard_normal((n, h, 4))).astype(np.float32)
    q0 = door_q0(n)
    frame = np.array([0.55, 0.35, 1.0], np.float32)
    if case != "nominal":
        frame = np.array([0.53, 0.39, 0.95], np.float32)
        q0[7] = np.nan
    qd0 = (0.1 * rng.standard_normal(q0.shape)).astype(np.float32)
    project = None
    if case == "projection":
        # half the doors open at 2 rad/s from closed: door_clamp holds them
        qd0[::2, 4] = 2.0
        project = door_clamp
    rew_p, qf_p, qdf_p = (to_np(x) for x in plain_rollout(
        door._model, door.dt, door.substeps, door.scalar_torque,
        door.scalar_reward, to_torch(q0), to_torch(qd0), to_torch(acts),
        DOOR, to_torch(frame), project_fn=project))
    if case == "projection":
        _, qf_free, _ = plain_rollout(
            door._model, door.dt, door.substeps, door.scalar_torque,
            door.scalar_reward, to_torch(q0), to_torch(qd0), to_torch(acts),
            DOOR, to_torch(frame))
        assert np.all(qf_p[::2, 4] <= 0.02)
        assert np.all(to_np(qf_free)[::2, 4] > 0.04)

    fn = load_host_rollout(_header(door, project))
    q0_t, qd0_t = np.ascontiguousarray(q0.T), np.ascontiguousarray(qd0.T)
    act_t = np.ascontiguousarray(acts.transpose(1, 2, 0))
    rew = np.empty((h, n), np.float32)
    qf, qdf = np.empty((6, n), np.float32), np.empty((6, n), np.float32)
    ptr = lambda a: a.ctypes.data
    assert fn(ptr(q0_t), ptr(qd0_t), ptr(act_t), ptr(frame), None, ptr(rew),
              ptr(qf), ptr(qdf), n, h) == 0
    np.testing.assert_allclose(rew.T, rew_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qf.T, qf_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qdf.T, qdf_p, rtol=1e-5, atol=1e-5)
    assert np.array_equal(np.isnan(rew.T), np.isnan(rew_p))


def test_emitter_counts_every_operation_and_no_bare_literal():
    """A three-line program by hand: an operation whose first operand is a
    literal counts (``0.5 * x``, ``1.0 - y``), a bare literal does not."""
    em = sm.Emitter()
    x = em.input("x", "x_in")
    y = 0.5 * x              # "0x1.0p-1f * x": one op
    sm.zeros_like(x)         # "0x0.0p+0f": a literal, no op
    z = 1.0 - y              # "0x1.0p+0f - t0": one op
    assert em.lines[1].endswith(f"= {sm.f32_literal(0.5)} * x;")
    assert em.lines[3].endswith(f"= {sm.f32_literal(1.0)} - {y.name};")
    assert z.name in em.lines[3]
    assert em.ops == 2


def _non_literal_lines(text):
    """The ``const float t...`` lines of a generated function whose
    expression is not a bare f32 literal."""
    exprs = re.findall(r"^  const float t\d+ = (.*);$", text, re.M)
    return [e for e in exprs if not sm._LITERAL.fullmatch(e)]


@pytest.mark.parametrize("name", ["door-v0", "hammer-v0-adroit"])
def test_ops_count_every_emitted_operation(name):
    """``Emitter.ops`` of each generated function is the number of its
    ``const float t...`` lines that are not a bare literal (inputs are
    ``q_0``-style lines and none of them); the bound's
    ``ops_per_lane_step`` is their sum over a control step."""
    from ppi_tpu_torch.envs.physics.rollout_kernel import _generate
    env = ENVS[name]()
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    args = body_args(env, state)
    text, ops = _generate(*args)
    bodies = {"torque": text.split("void env_torque(", 1)[1].split(
                  "PPI_QUAL", 1)[0],
              "substep": text.split("void env_substep(", 1)[1].split(
                  "PPI_QUAL", 1)[0],
              "reward": text.split("float env_reward(", 1)[1].split(
                  "PPI_QUAL", 1)[0]}
    for fn, body in bodies.items():
        assert ops[fn] == len(_non_literal_lines(body)), fn
    # operations whose first operand is a literal are counted too
    assert any(re.match(r"\(?-?0x", e)
               for e in _non_literal_lines(bodies["substep"]))
    assert ops_per_lane_step(*args) == (
        ops["torque"] + env.substeps * ops["substep"] + ops["project"]
        + ops["reward"] + 2 * env._model.nq)
