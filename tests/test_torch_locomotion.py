"""hopper, walker2d, walker~walk, humanoid-standup: the port's envs and
rollouts against the JAX package.

Planar bodies on sphere-plane ground contacts whose rewards take the step's
raw action. Two starts per env: "reset", drawn by the JAX reset (key 0),
and "contact", the reset lowered onto the ground (its lowest sphere 2-3 mm
into the plane), so the penalty contacts act from the first substep.
Torques of scale 0.75 x the box reach past it in about one cell of six.

hopper's and walker2d's healthy bonus is a step function of the torso's
height and pitch: the reward entries within THRESHOLD_BAND of its gate are
left out of the comparison and counted. walker~walk is walker2d's body
with dm_control's reward; its JAX reference is one compile shared with
walker2d: the port's walker~walk coordinates are walker2d's bit for bit
(held to JAX's walker2d rollout), and its rewards are held to JAX's
``WalkerWalk.scalar_reward`` on those coordinates (a second 35 s compile of
the same dynamics would exceed the suite's budget). Tolerances are
tests/test_torch_rollout.py's (tests/torch_env_helpers.py), but for one
measured bound: the joint velocities of hopper's and the walker's legs in
ground contact, up to 30 rad/s, are held to 1e-4 absolute. Their stiff
penalty contacts amplify f32 rounding: from the contact start, at H=4 (the
tests run H=3), both the port and JAX land 1.5e-5 to 3.2e-5 from a
float64 run of the port's plain version on the same inputs, so the two
differ by up to 4e-5 (seeds 0-9; standup's contacts stay inside REW_TOL).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_env_helpers import (
    assert_host_c_matches_plain,
    assert_kernel_step_is_the_eager_step, assert_model_equals_reference,
    assert_nan_lane_goes_nan_alone, assert_objective_costs_match,
    assert_reward_clips_the_raw_action, assert_rollout_close_off_thresholds,
    assert_uniform, jax_rollout_fn, pinned_jax_state, port_state, resets,
    run_on_cpu, step_coordinates, wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.runners.run_mpc import ENVS as JAX_ENVS
from ppi_tpu_torch.envs import hopper, standup, walker
from ppi_tpu_torch.envs.physics.engine_soa import make_sites_soa
from ppi_tpu_torch.runners.run_mpc import ENVS

N, H = 8, 3
NAMES = ["hopper", "walker2d", "walker~walk", "humanoid-standup"]
# per env: the state class, the reset noise, the healthy gate (torso
# height, |pitch|) or None, and the env whose JAX rollout is the reference
SPEC = {
    "hopper": (hopper.HopperState, 5e-3, (hopper.TORSO_Z0, 0.7, 0.6),
               "hopper"),
    "walker2d": (walker.WalkerState, 5e-3, (walker.TORSO_Z0, 0.8, 0.8),
                 "walker2d"),
    "walker~walk": (walker.WalkerState, 5e-3, None, "walker2d"),
    "humanoid-standup": (standup.StandupState, 0.01, None,
                         "humanoid-standup"),
}
PENETRATION = 2.5e-3
CONTACT_QD_TOL = dict(rtol=1e-5, atol=1e-4)
STIFF_LEGS = ("hopper", "walker2d", "walker~walk")
_REFERENCES = {}


def _contact_q(env, qpos):
    """``qpos`` lowered so that its lowest sphere is PENETRATION into the
    ground plane."""
    pts = to_np(make_sites_soa(env._model)(to_torch(qpos)))
    bottom = (pts[:, 2] - env._model.sphere_radius).min()
    q = np.array(qpos, np.float32)
    q[1] -= bottom + PENETRATION
    return q


def _acts(name):
    env = ENVS[name]()
    rng = np.random.default_rng(NAMES.index(name))
    return (0.75 * env.max_torque * rng.standard_normal(
        (N, H, env.action_dim))).astype(np.float32)


def reference(name):
    """{start: (JAX state, (rewards, qf, qdf))} of the env whose JAX rollout
    is ``name``'s reference: one compile per body, memoized."""
    ref_name = SPEC[name][3]
    if ref_name not in _REFERENCES:
        jenv = JAX_ENVS[ref_name]()
        run = jax_rollout_fn(jenv)
        js = jenv.reset(jax.random.key(0))
        contact = pinned_jax_state(
            js, qpos=_contact_q(ENVS[ref_name](), np.asarray(js.physics.qpos)))
        acts = _acts(ref_name)
        _REFERENCES[ref_name] = {s: (st, run(st, acts)) for s, st in
                                 (("reset", js), ("contact", contact))}
    return _REFERENCES[ref_name]


def _state(name, start):
    return port_state(SPEC[name][0], reference(name)[start][0])


@functools.cache
def _plain(name, start):
    """The port's plain rollout (rewards, qf, qdf) from ``start``."""
    return wrapper_run(ENVS[name](), _state(name, start),
                       _acts(SPEC[name][3]))


@functools.cache
def _coordinates(name, start):
    """The port's coordinates after each step from ``start``."""
    return step_coordinates(ENVS[name](), _state(name, start),
                            _acts(SPEC[name][3]))


def _gate_margin(name, start):
    """The distance of the torso's height and |pitch| to the healthy gate
    after each step (inf for a reward without one)."""
    gate = SPEC[name][2]
    if gate is None:
        return np.full((N, H), np.inf)
    z0, min_z, max_pitch = gate
    q, _ = _coordinates(name, start)
    return np.minimum(np.abs(q[..., 1] + z0 - min_z),
                      np.abs(np.abs(q[..., 2]) - max_pitch))


def _walk_reward_reference(start):
    """JAX's ``WalkerWalk.scalar_reward`` on the port's coordinates after
    each step."""
    q, qd = _coordinates("walker~walk", start)
    r = JAX_ENVS["walker~walk"]().scalar_reward(
        None, tuple(jnp.asarray(q[..., j]) for j in range(q.shape[-1])),
        tuple(jnp.asarray(qd[..., j]) for j in range(qd.shape[-1])), None)
    return np.asarray(r)


@pytest.mark.parametrize("name", NAMES)
def test_model_matches_reference(name):
    assert_model_equals_reference(JAX_ENVS[name](), ENVS[name]())


@pytest.mark.parametrize("name", NAMES)
def test_reset_distribution(name):
    """gym's locomotion reset: qpos and qvel += U(-noise, noise) about the
    JAX env's noise-free start."""
    noise = SPEC[name][1]
    pose = np.asarray(JAX_ENVS[name](fixed_init=True).reset(
        jax.random.key(0)).physics.qpos)
    states = resets(ENVS[name]())
    assert_uniform([to_np(s.physics.qpos) for s in states], pose - noise,
                   pose + noise)
    assert_uniform([to_np(s.physics.qvel) for s in states], -noise, noise)
    fixed = ENVS[name](fixed_init=True).reset(None, "cpu")
    np.testing.assert_array_equal(to_np(fixed.physics.qpos), pose)
    assert float(fixed.physics.qvel.abs().max()) == 0.0


def test_walker_full_range_reset():
    """dm_control's: the pitch U(-pi, pi), the leg hinges uniform over
    their limits, the slides and the velocities at rest."""
    lim = np.asarray(JAX_ENVS["walker2d"]()._model.q_limit[3:])
    q = np.stack([to_np(s.physics.qpos) for s in resets(
        walker.Walker(full_range_init=True))])
    np.testing.assert_array_equal(q[:, :2], 0.0)
    assert_uniform(q[:, 2:3], -math.pi, math.pi)
    assert_uniform(q[:, 3:], lim[:, 0], lim[:, 1])


@pytest.mark.parametrize("start", ["reset", "contact"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_rollout_matches_reference(name, start):
    ref = reference(name)[start][1]
    if name == "walker~walk":
        ref = (_walk_reward_reference(start), *ref[1:])
    qd_tol = CONTACT_QD_TOL if start == "contact" and name in STIFF_LEGS \
        else None
    masked = assert_rollout_close_off_thresholds(
        _plain(name, start), ref, _gate_margin(name, start), qd_tol)
    assert masked <= 2, f"{masked} reward entries at the healthy gate"


@pytest.mark.parametrize("start", ["reset", "contact"])
def test_walker_walk_moves_as_walker2d(start):
    """One body, two rewards: the same coordinates bit for bit."""
    walk, gym = _plain("walker~walk", start), _plain("walker2d", start)
    np.testing.assert_array_equal(walk[1], gym[1])
    np.testing.assert_array_equal(walk[2], gym[2])
    assert not np.allclose(walk[0], gym[0])


@pytest.mark.parametrize("name", NAMES)
def test_the_body_stays_on_the_ground(name):
    """From the contact start every lane ends the rollout within 3 cm of
    the ground, above or in it (the penalty holds the body up), and some
    lane still in it."""
    env = ENVS[name]()
    qf = reference(name)["contact"][1][1]
    pts = to_np(make_sites_soa(env._model)(to_torch(qf)))
    bottom = (pts[..., 2] - env._model.sphere_radius).min(-1)
    assert np.all(np.abs(bottom) < 0.03) and np.any(bottom < 0.0)


@pytest.mark.parametrize("name", NAMES)
def test_reward_clips_the_raw_action(name):
    assert_reward_clips_the_raw_action(
        ENVS[name](), _state(name, "contact"), _acts(SPEC[name][3]),
        ENVS[name]().max_torque, uses_action=name != "walker~walk",
        plain=_plain(name, "contact"))


@pytest.mark.parametrize("name", NAMES)
def test_step_is_the_kernel_step(name):
    s = _state(name, "contact")
    assert_kernel_step_is_the_eager_step(ENVS[name](), s,
                                         to_np(s.physics.qpos),
                                         _acts(SPEC[name][3])[0, 0])


@pytest.mark.parametrize("name", ["humanoid-standup", "walker~walk"])
def test_kernel_objective_costs_match_reference(name):
    """The objective's costs, whole and masked, against the reference
    rewards of a body without a gate."""
    rew = (_walk_reward_reference("contact") if name == "walker~walk"
           else reference(name)["contact"][1][0])
    assert_objective_costs_match(ENVS[name](), _state(name, "contact"),
                                 _acts(SPEC[name][3]), rew)


@pytest.mark.parametrize("name", NAMES)
def test_nan_lane_goes_nan_alone(name):
    assert_nan_lane_goes_nan_alone(ENVS[name](), _state(name, "contact"),
                                   _acts(SPEC[name][3]),
                                   clean=_plain(name, "contact")[0])


@pytest.mark.parametrize("name", NAMES)
def test_host_c_build_matches_plain(name):
    """The contact body (and walker~walk's expf) as host C, a NaN lane
    included. The host's libm is not torch's, so the legs' stiff contacts
    take the measured contact bound, as against JAX."""
    s = _state(name, "contact")
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    q0[3, 2] = np.nan
    qd0 = np.tile(to_np(s.physics.qvel), (N, 1))
    assert_host_c_matches_plain(
        ENVS[name](), s, _acts(SPEC[name][3]), q0, qd0,
        CONTACT_QD_TOL if name in STIFF_LEGS else None)


@functools.cache
def _hopper_split_build():
    """hopper's routed split body (the chain cut) as host C, generated and
    built once."""
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    env = ENVS["hopper"]()
    assert (rk.kernel_layout(env), rk.split_partition(env)) == (
        "split", "chain")
    return rk.load_host_split_rollout(rk.generate_split(
        *rk.body_args(env, _state("hopper", "reset")),
        partition=rk.split_partition(env))[0])


@pytest.mark.parametrize("start", ["reset", "contact"])
def test_hopper_routed_split_build_matches_reference(start):
    """hopper routes to the split layout with its one chain cut into
    segments: that body built as host C against ``ppi_tpu``'s rollout on
    the same numpy inputs within the tolerances of the plain path's
    comparison (the healthy gate's entries left out, the stiff contacts
    at the measured contact bound)."""
    from test_torch_warp_layout import _host_run, _needs_cc
    _needs_cc()
    env, s = ENVS["hopper"](), _state("hopper", start)
    run = _hopper_split_build()
    q0 = np.tile(to_np(s.physics.qpos), (N, 1))
    qd0 = np.tile(to_np(s.physics.qvel), (N, 1))
    masked = assert_rollout_close_off_thresholds(
        _host_run(run, env, s, q0, qd0, _acts("hopper")),
        reference("hopper")[start][1], _gate_margin("hopper", start),
        CONTACT_QD_TOL if start == "contact" else None)
    assert masked <= 2, f"{masked} reward entries at the healthy gate"


@pytest.mark.parametrize("name", NAMES)
def test_observe_matches_reference(name):
    jenv, env = JAX_ENVS[name](), ENVS[name]()
    for start in ("reset", "contact"):
        js = reference(name)[start][0]
        np.testing.assert_allclose(
            to_np(env.observe(port_state(SPEC[name][0], js))),
            np.asarray(jenv.observe(js)), rtol=1e-6, atol=1e-6)
    assert not hasattr(env, "success") and not hasattr(jenv, "success")


def test_standup_head_height_matches_reference():
    js = reference("humanoid-standup")["contact"][0]
    jenv, env = JAX_ENVS["humanoid-standup"](), ENVS["humanoid-standup"]()
    got = env.head_height(to_torch(js.physics.qpos))
    np.testing.assert_allclose(float(got), float(jenv.head_height(
        js.physics.qpos)), rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_runner_runs_locomotion_on_cpu(name):
    run_on_cpu(["Mppi", name, "ColouredNoise", "--beta", "2", "--alpha",
                "10", "--anneal", "0.9"], ENVS[name]().action_dim,
               success_test=False)
