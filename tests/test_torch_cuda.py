"""The port's kernels on a CUDA card against their plain versions.

Marked ``cuda``; each test skips without a card. These need no JAX, so on
a machine with a card and without JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_helpers import door_q0
from ppi_tpu_torch.envs.base import risk_aggregate
from ppi_tpu_torch.envs.door import DOOR, Door
from ppi_tpu_torch.envs.physics import rollout_kernel as rk

pytestmark = pytest.mark.cuda

N, H = 300, 8


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _acts(dev, n=N, h=H):
    rng = np.random.default_rng(0)
    return torch.from_numpy((0.4 * rng.standard_normal((n, h, 4))).astype(
        np.float32)).to(dev)


def _rel(a, b):
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def test_kernel_matches_plain_and_counts_its_launch():
    dev = _device()
    door = Door(fixed_scene=True)
    s0 = door.reset(None, dev)
    acts = _acts(dev)
    run = rk.make_rollout(door._model, door.dt, door.substeps, H, 4,
                          door.scalar_torque, door.scalar_reward,
                          dyn_body=DOOR)
    q0 = torch.from_numpy(door_q0(N)).to(dev)
    before = rk.LAUNCHES["rollout"]
    rew, qf, qdf = run(q0, torch.zeros_like(q0), acts, dyn=s0.frame)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rollout"] == before + 1
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(door, s0, q0,
                                              torch.zeros_like(q0), acts)
    assert _rel(rew, rew_p) <= 1e-4
    assert _rel(qf, qf_p) <= 1e-4
    assert _rel(qdf, qdf_p) <= 1e-4


@pytest.mark.parametrize("layout", ["lane", "warp", "split"])
def test_staged_launches_equal_the_call_and_count_each_launch(layout):
    """``run.launch`` on what ``run.stage`` laid out once gives the call's
    bits at every launch, into the same outputs, one count a launch."""
    dev = _device()
    door = Door(fixed_scene=True)
    s0 = door.reset(None, dev)
    acts = _acts(dev)
    run = rk.env_rollout(door, s0, H, layout=layout)
    q0 = torch.from_numpy(door_q0(N)).to(dev)
    qd0 = torch.zeros_like(q0)
    consts, _, dyn = rk.kernel_operands(door, s0)
    want = run(q0, qd0, acts, consts=consts, dyn=dyn)
    staged = run.stage(q0, qd0, acts, consts=consts, dyn=dyn)
    key = rk.LAUNCH_KEYS[layout]
    before = rk.LAUNCHES[key]
    first = run.launch(staged)
    again = run.launch(staged)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[key] == before + 2
    for a, b, c in zip(want, first, again):
        assert torch.equal(a, b) and torch.equal(a, c)
        assert b.data_ptr() == c.data_ptr()


def test_kernel_isolates_a_nan_lane_and_masks_the_ragged_edge():
    dev = _device()
    door = Door(fixed_scene=True)
    s0 = door.reset(None, dev)
    n = 129  # one lane past a 128-thread block
    run = rk.make_rollout(door._model, door.dt, door.substeps, H, 4,
                          door.scalar_torque, door.scalar_reward,
                          dyn_body=DOOR)
    q0 = torch.from_numpy(door_q0(n)).to(dev)
    q0[128] = torch.nan
    rew, qf, _ = run(q0, torch.zeros_like(q0), _acts(dev, n), dyn=s0.frame)
    assert rew.shape == (n, H) and qf.shape == (n, 6)
    assert bool(torch.isnan(rew[128]).all())
    assert bool(torch.isfinite(rew[:128]).all())


def test_kernel_objective_with_sampled_frame_matches_plain():
    dev = _device()
    door = Door()
    s0 = door.reset(torch.Generator(dev).manual_seed(3), dev)
    acts = _acts(dev)
    mask = (torch.arange(H, device=dev) < H - 2).float()
    c_k = rk.kernel_mpc_objective(door, s0, H, mask)(None, acts)
    n = acts.shape[0]
    rew_p, _, _ = rk.env_plain_rollout(door, s0,
                                       s0.physics.qpos.expand(n, -1),
                                       s0.physics.qvel.expand(n, -1), acts)
    assert _rel(c_k, risk_aggregate(rew_p, mask)) <= 1e-4


def test_kernel_rejects_bad_inputs():
    dev = _device()
    door = Door()
    run = rk.make_rollout(door._model, door.dt, door.substeps, H, 4,
                          door.scalar_torque, door.scalar_reward,
                          dyn_body=DOOR)
    q0 = torch.zeros((4, 6), device=dev)
    with pytest.raises(ValueError):
        run(q0, q0, _acts(dev, 4), dyn=None)
    with pytest.raises(TypeError):
        run(q0.double(), q0, _acts(dev, 4),
            dyn=torch.zeros(3, device=dev))


def test_ppi_iteration_and_control_step_never_wait_for_the_card():
    """No operation of a PPI iteration, a control step or the real env step
    synchronizes with the host (an implicit .item() would make the host
    wait for the rollout kernel before issuing the update)."""
    dev = _device()
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.mpc import Mpc
    from ppi_tpu_torch.policies import design_moments, make_policy
    door = Door()
    mean, ci, co = design_moments(door.action_low, door.action_high, 1000.0)
    fam, pol = make_policy("SquaredExponentialKernel",
                           door.dt * torch.arange(H), 4, mean, ci, co,
                           lengthscale=0.08, lower=door.action_low,
                           upper=door.action_high, device=dev)
    agent = Mpc(env=door, solver=make_solver("Lbps", delta=0.9), family=fam,
                timesteps=20, horizon=H, n_samples=64, n_iters=2, anneal=0.5,
                device=dev)
    state = door.reset(torch.Generator(dev).manual_seed(0), dev)
    carry = agent.init(pol, torch.Generator(dev).manual_seed(0))
    carry, _ = agent.warm_start(carry, state, 2)  # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            action, carry, _ = agent.control_step(carry, state, t)
            state, _ = door.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(state.physics.qpos).all())


# ---- the moment-match kernel ---------------------------------------------------

def _mm_inputs(dev, n, d, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (offset + rng.standard_normal((n, d))).astype(np.float32)
    lw = rng.normal(scale=3.0, size=n).astype(np.float32)
    lw[rng.permutation(n)[: n // 4]] = -np.inf
    return torch.from_numpy(lw).to(dev), torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("n, d", [(4096, 64), (1000, 17), (300, 130),
                                  (4000, 640)])
def test_moment_match_kernel_matches_plain_and_counts_launches(n, d):
    """Ragged N and d; kernel vs plain within 1e-5 (mu, sigma; unit-scale
    data) and 1e-5 relative (ESS), as the host-C build is held on the
    CPU."""
    dev = _device()
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.ops.cuda_ops import (
        m_projection_cuda, m_projection_plain)
    lw, x = _mm_inputs(dev, n, d)
    before = LAUNCHES["moment_match"]
    got = m_projection_cuda(lw, x)
    torch.cuda.synchronize()
    assert LAUNCHES["moment_match"] == before + 1
    mu, sigma, ess = got
    mu0, sigma0, ess0 = m_projection_plain(lw, x)
    assert mu.shape == (d,) and sigma.shape == (d, d) and ess.shape == ()
    assert float((mu - mu0).abs().max()) <= 1e-5
    assert float((sigma - sigma0).abs().max()) <= 1e-5
    assert abs(float(ess) - float(ess0)) <= 1e-5 * float(ess0)


def test_moment_match_kernel_is_deterministic():
    dev = _device()
    from ppi_tpu_torch.ops.cuda_ops import m_projection_cuda
    lw, x = _mm_inputs(dev, 16384, 640, seed=1)
    first = m_projection_cuda(lw, x)
    for _ in range(3):
        again = m_projection_cuda(lw, x)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_moment_match_makes_three_launches_and_no_other_device_op():
    """One call at (4096, 640) under ``torch.profiler``: the card runs the
    three kernels of ``moment_match.cu`` (prologue, main, epilogue) and
    nothing else -- no PyTorch kernel, copy or memset -- and the launch
    counter adds one."""
    dev = _device()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.ops.cuda_ops import m_projection_cuda
    lw, x = _mm_inputs(dev, 4096, 640)
    m_projection_cuda(lw, x)   # builds and loads the kernels first
    torch.cuda.synchronize()
    before = LAUNCHES["moment_match"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m_projection_cuda(lw, x)
        torch.cuda.synchronize()
    assert LAUNCHES["moment_match"] == before + 1
    on_card = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(on_card) == 3, on_card
    for stem in ("mm_prologue", "mm_main", "mm_epilogue"):
        assert sum(stem in name for name in on_card) == 1, on_card


def test_moment_match_kernel_rejects_bad_inputs():
    dev = _device()
    from ppi_tpu_torch.ops.cuda_ops import m_projection_cuda
    lw, x = _mm_inputs(dev, 64, 8)
    with pytest.raises(TypeError):
        m_projection_cuda(lw.double(), x)
    with pytest.raises(TypeError):
        m_projection_cuda(lw.cpu(), x)
    with pytest.raises(ValueError, match="contiguous"):
        m_projection_cuda(lw, torch.zeros((8, 64), device=dev).T)
    with pytest.raises(ValueError, match="shapes"):
        m_projection_cuda(lw[:63], x)


def test_optimization_iteration_never_waits_for_the_card():
    """One Reps iteration at d=64, N=4096 (sample, NoisySphere, mask,
    temperature search, the kernel's moment match, PD guards, KL) runs
    no operation that synchronizes with the host."""
    dev = _device()
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.algorithms.base import _one_iteration
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.envs.functions import make_function
    from ppi_tpu_torch.policies.gaussian import Gaussian
    d, n = 64, 4096
    fam = Gaussian(dim=d)
    state = fam.init(torch.ones(d, device=dev),
                     0.5 * torch.eye(d, device=dev))
    step = _one_iteration(make_solver("Reps"), fam,
                          make_function("NoisySphere", d), n)
    gen = torch.Generator(dev).manual_seed(0)
    state, _ = step(state, gen)  # builds and loads the kernel first
    torch.cuda.synchronize()
    before = LAUNCHES["moment_match"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, (stats, _, _) = step(state, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert LAUNCHES["moment_match"] == before + 1
    assert bool(torch.isfinite(stats["mean"])) and bool(
        torch.isfinite(state.sigma).all())


@pytest.mark.parametrize("sampler", ["mc", "qmc"])
@pytest.mark.parametrize("algorithm", ["Ais", "Cem", "iCem", "Reps", "Lbps",
                                       "More", "Essps", "Mppi",
                                       "MppiUpdateCovariance"])
def test_every_solver_runs_on_the_card(algorithm, sampler):
    """Three iterations of run_opt at d=64, N=4096: finite costs, and one
    moment-match kernel launch per iteration for every solver whose update
    is a moment match (all but MORE)."""
    _device()
    from ppi_tpu_torch.build import LAUNCHES
    from ppi_tpu_torch.runners import run_opt
    args = run_opt.build_parser().parse_args([
        algorithm, "NoisySphere", "--dimension", "64", "--n-iter", "3",
        "--device", "cuda", sampler, "--n-samples", "4096"])
    before = LAUNCHES["moment_match"]
    state, trace = run_opt.main(args)
    assert np.isfinite(trace["mean"]).all()
    assert bool(torch.isfinite(state.mu).all())
    expected = 0 if algorithm == "More" else 3
    assert LAUNCHES["moment_match"] == before + expected


# ---- variant (b): reward constants and action rewards --------------------------

def _variant_b_env(name):
    from ppi_tpu_torch.runners.run_mpc import ENVS
    return ENVS[name]()


# per env: the scale of the random actions (cheetah's reach past +-30)
ACTION_SCALE = {"pen-v0": 0.12, "relocate-v0": 0.3, "cheetah": 25.0}


@pytest.mark.parametrize("name", sorted(ACTION_SCALE))
def test_variant_b_kernel_matches_plain(name):
    """Each new body at N=257 (ragged), H=5, from a sampled goal or start:
    rewards and final state within 1e-4 of the plain version."""
    dev = _device()
    env = _variant_b_env(name)
    s0 = env.reset(torch.Generator(dev).manual_seed(1), dev)
    n, h = 257, 5
    rng = np.random.default_rng(2)
    acts = torch.from_numpy((ACTION_SCALE[name] * rng.standard_normal(
        (n, h, env.action_dim))).astype(np.float32)).to(dev)
    consts, _, _ = rk.kernel_operands(env, s0)
    run = rk.env_rollout(env, s0, h)
    q0 = s0.physics.qpos.expand(n, -1).contiguous()
    qd0 = s0.physics.qvel.expand(n, -1).contiguous()
    key = rk.launch_key(env)   # relocate-v0 and cheetah: the split layout
    before = rk.LAUNCHES[key]
    rew, qf, qdf = run(q0, qd0, acts, consts=consts)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[key] == before + 1
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    assert _rel(rew, rew_p) <= 1e-4
    assert _rel(qf, qf_p) <= 1e-4
    assert _rel(qdf, qdf_p) <= 1e-4


def test_consts_are_checked_for_device_and_dtype():
    dev = _device()
    env = _variant_b_env("pen-v0")
    s0 = env.reset(torch.Generator(dev).manual_seed(0), dev)
    run = rk.make_rollout(env._model, env.dt, env.substeps, 2, 4,
                          env.scalar_torque, env.scalar_reward, n_consts=3)
    q0 = s0.physics.qpos.expand(4, -1).contiguous()
    acts = torch.zeros((4, 2, 4), device=dev)
    with pytest.raises(ValueError, match="consts"):
        run(q0, q0 * 0.0, acts, consts=s0.target_axis.cpu())
    with pytest.raises(ValueError, match="consts"):
        run(q0, q0 * 0.0, acts, consts=s0.target_axis.double())
    with pytest.raises(ValueError, match="consts"):
        run(q0, q0 * 0.0, acts)


def test_coloured_noise_control_step_never_waits_for_the_card():
    """One Mppi control step with the ColouredNoise prior on relocate-v0,
    and the real env step, run no operation that synchronizes with the
    host; each is one launch."""
    dev = _device()
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.mpc import Mpc
    from ppi_tpu_torch.policies import design_moments, make_policy
    env = _variant_b_env("relocate-v0")
    mean, ci, co = design_moments(env.action_low, env.action_high, 1000.0)
    fam, pol = make_policy("ColouredNoise", env.dt * torch.arange(H), 6,
                           mean, ci, co, beta=2.0, lower=env.action_low,
                           upper=env.action_high, device=dev)
    agent = Mpc(env=env, solver=make_solver("Mppi", alpha=10.0), family=fam,
                timesteps=20, horizon=H, n_samples=64, anneal=0.9,
                device=dev)
    state = env.reset(torch.Generator(dev).manual_seed(0), dev)
    carry = agent.init(pol, torch.Generator(dev).manual_seed(0))
    carry, _ = agent.warm_start(carry, state, 2)  # builds and loads first
    torch.cuda.synchronize()
    key = rk.launch_key(env)   # the split layout
    before = rk.LAUNCHES[key]
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, carry, _ = agent.control_step(carry, state, 1)
        state, _ = env.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[key] == before + 2
    assert bool(torch.isfinite(state.physics.qpos).all())


# ---- variants (c) and (d): the projection and the hand door scenes ------------

HAND_ENVS = ["door-v0-hand", "door-v0-adroit"]


def _hand_lanes(env, dev, n, h):
    """From a sampled frame: the reset posture in the first half of the
    lanes, the door opening from 0.02 rad in the rest, with the latch up
    (the clamp fires) and, in the last quarter, pressed (it does not)."""
    s0 = env.reset(torch.Generator(dev).manual_seed(1), dev)
    q0 = s0.physics.qpos.expand(n, -1).clone()
    qd0 = torch.zeros_like(q0)
    door, latch = env.scalar_dyn_body, env._latch
    q0[n // 2:, door] = 0.02
    qd0[n // 2:, door] = 1.0
    q0[3 * n // 4:, latch] = -1.0
    rng = np.random.default_rng(2)
    acts = q0[:, None, :env.action_dim] + torch.from_numpy(
        (0.3 * rng.standard_normal((n, h, env.action_dim))).astype(
            np.float32)).to(dev)
    return s0, q0, qd0, acts


@pytest.mark.parametrize("name", HAND_ENVS)
def test_hand_kernel_matches_plain(name):
    """Each body at N=257 (ragged), H=4, from a sampled frame, clamped and
    free lanes: rewards and final state within 1e-4 of the plain version,
    and the clamp holds the same lanes at the bolt depth."""
    dev = _device()
    env = _variant_b_env(name)
    n, h = 257, 4
    s0, q0, qd0, acts = _hand_lanes(env, dev, n, h)
    run = rk.env_rollout(env, s0, h)
    before = rk.LAUNCHES[rk.launch_key(env)]
    rew, qf, qdf = run(q0, qd0, acts, dyn=s0.frame)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.launch_key(env)] == before + 1
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    assert _rel(rew, rew_p) <= 1e-4
    assert _rel(qf, qf_p) <= 1e-4
    assert _rel(qdf, qdf_p) <= 1e-4
    door = env.scalar_dyn_body
    held = qf_p[:, door] == env.bolt_depth
    assert bool(held[n // 2:3 * n // 4].all()) and not bool(
        held[3 * n // 4:].any())
    assert torch.equal(qf[:, door] == env.bolt_depth, held)


@pytest.mark.parametrize("name", HAND_ENVS)
def test_hand_real_step_is_one_kernel_launch(name):
    """The real env step on the card: one launch at N=1, H=1, within 1e-4
    of the eager step (``plain_step``)."""
    dev = _device()
    env = _variant_b_env(name)
    s0 = env.reset(torch.Generator(dev).manual_seed(0), dev)
    action = s0.physics.qpos[:env.action_dim] + 0.2
    before = rk.LAUNCHES[rk.launch_key(env)]
    s1, r1 = env.step(s0, action)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.launch_key(env)] == before + 1
    s2, r2 = env.plain_step(s0, action)
    assert r1.shape == () and int(s1.t) == 1
    assert _rel(s1.physics.qpos, s2.physics.qpos) <= 1e-4
    assert _rel(s1.physics.qvel, s2.physics.qvel) <= 1e-4
    assert _rel(r1, r2) <= 1e-4


@pytest.mark.parametrize("name", HAND_ENVS)
def test_hand_control_step_never_waits_for_the_card(name):
    """One Lbps control step (2 iterations) and the real env step through
    the kernel: three launches, no operation that synchronizes with the
    host."""
    dev = _device()
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.mpc import Mpc
    from ppi_tpu_torch.policies import design_moments, make_policy
    env = _variant_b_env(name)
    mean, ci, co = design_moments(env.action_low, env.action_high, 1000.0)
    fam, pol = make_policy("SquaredExponentialKernel",
                           env.dt * torch.arange(H), env.action_dim, mean,
                           ci, co, lengthscale=0.08, lower=env.action_low,
                           upper=env.action_high, device=dev)
    agent = Mpc(env=env, solver=make_solver("Lbps", delta=0.9), family=fam,
                timesteps=20, horizon=H, n_samples=64, n_iters=2, anneal=0.5,
                device=dev)
    state = env.reset(torch.Generator(dev).manual_seed(0), dev)
    carry = agent.init(pol, torch.Generator(dev).manual_seed(0))
    carry, _ = agent.warm_start(carry, state, 1)  # builds and loads first
    env.step(state, agent.action(carry))
    torch.cuda.synchronize()
    before = rk.LAUNCHES[rk.launch_key(env)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, carry, _ = agent.control_step(carry, state, 1)
        state, _ = env.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.launch_key(env)] == before + 3
    assert bool(torch.isfinite(state.physics.qpos).all())


# ---- hammer-v0 and the 3-digit hand scenes --------------------------------------

SCENE_ENVS = {"hammer-v0": 0.4, "pen-v0-hand": 0.5, "relocate-v0-hand": 0.3,
            "hammer-v0-hand": 0.3}   # env -> scale of the random actions


def _scene_lanes(env, dev, n, h, scale):
    """From a sampled board or goal: the reset posture in every lane and
    actions about it."""
    s0 = env.reset(torch.Generator(dev).manual_seed(1), dev)
    q0 = s0.physics.qpos.expand(n, -1).contiguous()
    rng = np.random.default_rng(2)
    acts = q0[:, None, -env.action_dim:] if env.name == "pen-v0-hand" \
        else q0[:, None, :env.action_dim]
    acts = acts + torch.from_numpy((scale * rng.standard_normal(
        (n, h, env.action_dim))).astype(np.float32)).to(dev)
    return s0, q0, torch.zeros_like(q0), acts


@pytest.mark.parametrize("name", sorted(SCENE_ENVS))
def test_scene_kernel_matches_plain(name):
    """Each body at N=257 (ragged), H=4, from a sampled board or goal:
    rewards and final state within 1e-6 of the plain version."""
    dev = _device()
    env = _variant_b_env(name)
    n, h = 257, 4
    s0, q0, qd0, acts = _scene_lanes(env, dev, n, h, SCENE_ENVS[name])
    consts, _, dyn = rk.kernel_operands(env, s0)
    run = rk.env_rollout(env, s0, h)
    before = rk.LAUNCHES[rk.launch_key(env)]
    rew, qf, qdf = run(q0, qd0, acts, consts=consts, dyn=dyn)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.launch_key(env)] == before + 1
    rew_p, qf_p, qdf_p = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    assert bool(torch.isfinite(rew_p).all())
    assert _rel(rew, rew_p) <= 1e-6
    assert _rel(qf, qf_p) <= 1e-6
    assert _rel(qdf, qdf_p) <= 1e-6


@pytest.mark.parametrize("name", sorted(SCENE_ENVS))
def test_scene_real_step_is_one_kernel_launch(name):
    """The real env step on the card: one launch at N=1, H=1, within 1e-6
    of the eager step (``plain_step``)."""
    dev = _device()
    env = _variant_b_env(name)
    s0, _, _, acts = _scene_lanes(env, dev, 1, 1, 0.2)
    before = rk.LAUNCHES[rk.launch_key(env)]
    s1, r1 = env.step(s0, acts[0, 0])
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.launch_key(env)] == before + 1
    s2, r2 = env.plain_step(s0, acts[0, 0])
    assert r1.shape == () and int(s1.t) == 1
    assert _rel(s1.physics.qpos, s2.physics.qpos) <= 1e-6
    assert _rel(s1.physics.qvel, s2.physics.qvel) <= 1e-6
    assert _rel(r1, r2) <= 1e-6


@pytest.mark.parametrize("policy", ["RffFeatures", "RbfFeatures",
                                    "Matern32Kernel", "WhiteNoiseKernel"])
def test_essps_control_step_never_waits_for_the_card(policy):
    """One Essps control step on hammer-v0 with a feature or kernel prior
    (the basis constants are cached on the card, the window shift is
    decided on the host) and the real env step through the kernel: two
    launches, no operation that synchronizes with the host."""
    dev = _device()
    from ppi_tpu_torch.algorithms import make_solver
    from ppi_tpu_torch.mpc import Mpc
    from ppi_tpu_torch.policies import design_moments, make_policy
    env = _variant_b_env("hammer-v0")
    mean, ci, co = design_moments(env.action_low, env.action_high, 1000.0)
    span = 20 if policy == "RbfFeatures" else H
    fam, pol = make_policy(policy, env.dt * torch.arange(span),
                           env.action_dim, mean, ci, co, lengthscale=0.15,
                           lower=env.action_low, upper=env.action_high,
                           device=dev)
    agent = Mpc(env=env, solver=make_solver(
        "Essps", n_elites=10, dimension=fam.dim_features), family=fam,
        timesteps=20, horizon=H, n_samples=64, device=dev)
    state = env.reset(torch.Generator(dev).manual_seed(0), dev)
    carry = agent.init(pol, torch.Generator(dev).manual_seed(0))
    carry, _ = agent.warm_start(carry, state, 2)  # builds and loads first
    action, carry, _ = agent.control_step(carry, state, 0)
    state, _ = env.step(state, action)
    torch.cuda.synchronize()
    before = rk.LAUNCHES[rk.launch_key(env)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        action, carry, _ = agent.control_step(carry, state, 1)
        state, _ = env.step(state, action)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[rk.launch_key(env)] == before + 2
    assert bool(torch.isfinite(state.physics.qpos).all())


# ---- the warp layout: door-v0-adroit, hammer-v0-adroit, relocate-v0-adroit,
# door-v0-hand, hammer-v0-hand, relocate-v0-hand, pen-v0-adroit, fetch-pick ---

# env -> (check H, whether the rewards equal the plain version's bit for
# bit): the relocate bodies' rewards divide a sum over the tip spheres by
# their number, not a power of two, which PyTorch on the card does as a
# multiplication by the reciprocal and the kernel as a division; the
# one-ulp quotient carries through the rest of the reward,
# which then agrees within REWARD_TOL of 1 + |plain| (fetch-pick divides
# by its 4 tips, exactly). pen-v0-adroit's solve starts with its constant
# head (three folded pivots)
WARP_ENVS = {"door-v0-adroit": (5, True), "hammer-v0-adroit": (3, True),
             "relocate-v0-adroit": (3, False), "door-v0-hand": (5, True),
             "hammer-v0-hand": (5, True), "relocate-v0-hand": (5, False),
             "pen-v0-adroit": (3, True), "fetch-pick": (5, True)}
REWARD_TOL = 1e-6


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _same_rewards(a, b, exact):
    """Bit for bit, or (``exact`` false) NaN where ``b`` is and the rest
    within REWARD_TOL."""
    if exact:
        return _same_bits(a, b)
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and (bool(nan.all()) or _rel(a[~nan], b[~nan]) <= REWARD_TOL))


@pytest.mark.parametrize("name", sorted(WARP_ENVS))
def test_warp_layout_equals_plain(name):
    """The warp layout at N=257 (ragged: past a whole number of rollouts
    a block at any block size), from a sampled frame or board: one launch
    counted under ``rollout_warp``, rewards and final state bit for bit
    those of the lane layout and of the plain version (the rewards within
    REWARD_TOL where they are not exact); the real step one warp launch,
    bit for bit the eager step (its reward within the same tolerance)."""
    dev = _device()
    env = _variant_b_env(name)
    n, (h, exact) = 257, WARP_ENVS[name]
    s0 = env.reset(torch.Generator(dev).manual_seed(1), dev)
    q0 = s0.physics.qpos.expand(n, -1).contiguous()
    qd0 = torch.zeros_like(q0)
    rng = np.random.default_rng(2)
    acts = q0[:, None, :env.action_dim] + torch.from_numpy(
        (0.3 * rng.standard_normal((n, h, env.action_dim))).astype(
            np.float32)).to(dev)
    consts, _, dyn = rk.kernel_operands(env, s0)
    assert rk.launch_key(env) == "rollout_warp"
    before = rk.LAUNCHES["rollout_warp"]
    warp = rk.env_rollout(env, s0, h)(q0, qd0, acts, consts=consts, dyn=dyn)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rollout_warp"] == before + 1
    lane = rk.env_rollout(env, s0, h, layout="lane")(q0, qd0, acts,
                                                     consts=consts, dyn=dyn)
    plain = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    assert bool(torch.isfinite(plain[0]).all())
    for i, (w, l, p) in enumerate(zip(warp, lane, plain)):
        assert _same_bits(w, l)
        assert _same_rewards(w, p, exact) if i == 0 else _same_bits(w, p)
    action = acts[0, 0]
    before = rk.LAUNCHES["rollout_warp"]
    (s_k, r_k), (s_e, r_e) = env.step(s0, action), env.plain_step(s0, action)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rollout_warp"] == before + 1
    assert _same_bits(s_k.physics.qpos, s_e.physics.qpos)
    assert _same_bits(s_k.physics.qvel, s_e.physics.qvel)
    assert _same_rewards(r_k, r_e, exact)


# ---- the split layout: door-v0 and hammer-v0 ------------------------------------

SPLIT_ENVS = ("door-v0", "hammer-v0")
SENTINEL, PAD = -12345.0, 64


@pytest.mark.parametrize("name", SPLIT_ENVS)
def test_split_layout_equals_lane_layout(name, monkeypatch):
    """The split layout (door-v0 routes to it; hammer-v0, which keeps the
    lane layout, is put on it here) at N=257 (ragged: 8 groups of 32
    rollouts and one more), H=4, from a sampled frame or board, with a NaN
    lane: one launch counted under ``rollout_split``; rewards and
    final state bit for bit those of the lane layout and of the plain
    version, the NaN lane's too (the card's NaN is canonical); the NaN
    lane's rewards NaN and every other lane's finite; nothing written past
    N (sentinel-padded outputs); the real step one split launch, bit for
    bit the eager step."""
    dev = _device()
    env = _variant_b_env(name)
    n, h = 257, 4
    s0, q0, qd0, acts = _scene_lanes(env, dev, n, h, 0.4)
    q0 = q0.clone()
    q0[100] = torch.nan
    consts, _, dyn = rk.kernel_operands(env, s0)
    assert rk.kernel_layout(env) == ("split" if name == "door-v0"
                                     else "lane")
    monkeypatch.setattr(type(env), "scalar_kernel_layout", "split",
                        raising=False)
    assert rk.launch_key(env) == "rollout_split"
    run = rk.env_rollout(env, s0, h)
    before = rk.LAUNCHES["rollout_split"]
    split = run(q0, qd0, acts, consts=consts, dyn=dyn)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rollout_split"] == before + 1
    lane = rk.env_rollout(env, s0, h, layout="lane")(q0, qd0, acts,
                                                     consts=consts, dyn=dyn)
    plain = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    for s, l, p in zip(split, lane, plain):
        assert _same_bits(s, l) and _same_bits(s, p)
    keep = torch.arange(n, device=dev) != 100
    assert bool(torch.isnan(split[0][100]).all())
    assert bool(torch.isfinite(split[0][keep]).all())

    # one launch into outputs padded past N with a sentinel (the inputs in
    # the kernel's lane-major layout, held until the launch has run)
    nq = q0.shape[1]
    ins = [q0.t().contiguous(), qd0.t().contiguous(),
           acts.permute(1, 2, 0).contiguous()]
    outs = [torch.full((k * n + PAD,), SENTINEL, device=dev)
            for k in (h, nq, nq)]
    err = run.load()(*[x.data_ptr() for x in ins], dyn.data_ptr(), None,
                     *[x.data_ptr() for x in outs], n, h,
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for x, (k, ref) in zip(outs, ((h, split[0]), (nq, split[1]),
                                  (nq, split[2]))):
        assert bool((x[k * n:] == SENTINEL).all())
        assert _same_bits(x[:k * n].view(k, n).t(), ref)

    action = acts[0, 0]
    before = rk.LAUNCHES["rollout_split"]
    (s_k, r_k), (s_e, r_e) = env.step(s0, action), env.plain_step(s0, action)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["rollout_split"] == before + 1
    assert _same_bits(s_k.physics.qpos, s_e.physics.qpos)
    assert _same_bits(s_k.physics.qvel, s_e.physics.qvel)
    assert _same_bits(r_k, r_e)


# ---- the split layout's subtree partition ------------------------------------

# the locomotion bodies' random torques: 0.75 of the box, as chip_smoke.py's
LOCOMOTION_SCALE = 0.75
# fetch-push's random PD targets about the arm's posture, as chip_smoke.py's
PUSH_SCALE = 1.2
# the partition each body routes to
PARTITIONED = {"relocate-v0": "subtree", "cheetah": "subtree",
               "walker2d": "subtree", "walker~walk": "subtree",
               "humanoid-standup": "subtree", "pen-v0-hand": "subtree",
               "fetch-push": "chain", "hopper": "chain", "pen-v0": "chain",
               "reacher": "chain", "finger~spin": "chain"}


@pytest.mark.parametrize("name", list(PARTITIONED))
def test_partitioned_split_layout_equals_lane_layout(name):
    """relocate-v0, cheetah, walker2d, walker~walk, humanoid-standup and
    pen-v0-hand route to the split layout, their substep partitioned by
    the body tree, and fetch-push, hopper, pen-v0, reacher and finger~spin
    with their heaviest chain of bodies cut into segments: at N=257
    (ragged), H=5,
    from a sampled goal or start (pen-v0-hand: its PD targets about the digits' posture, as
    the scene tests'; fetch-push: about the arm's), with a NaN lane, one
    launch counted under
    ``rk.launch_key(env)`` (``rollout_split``); rewards and final state
    bit for bit the lane layout's (the NaN lane's too) and within 1e-4 of
    the plain version (cheetah's control cost divides by 5,400: one ulp
    off plain on the card); the NaN lane's rewards NaN and every other
    lane's finite; the real step one split launch, bit for bit the lane
    layout's step."""
    dev = _device()
    env = _variant_b_env(name)
    assert rk.kernel_layout(env) == "split"
    assert rk.split_partition(env) == PARTITIONED[name]
    key = rk.launch_key(env)
    assert key == "rollout_split"
    n, h = 257, 5
    if name in SCENE_ENVS:
        s0, q0, qd0, acts = _scene_lanes(env, dev, n, h, SCENE_ENVS[name])
        q0 = q0.clone()
    else:
        s0 = env.reset(torch.Generator(dev).manual_seed(1), dev)
        rng = np.random.default_rng(2)
        scale = (ACTION_SCALE[name] if name in ACTION_SCALE
                 else PUSH_SCALE if name == "fetch-push"
                 else LOCOMOTION_SCALE * env.max_torque)
        acts = torch.from_numpy((scale * rng.standard_normal(
            (n, h, env.action_dim))).astype(np.float32)).to(dev)
        if name == "fetch-push":
            acts = acts + s0.physics.qpos[:env.action_dim]
        q0 = s0.physics.qpos.expand(n, -1).clone()
        qd0 = s0.physics.qvel.expand(n, -1).contiguous()
    q0[100] = torch.nan
    consts, _, _ = rk.kernel_operands(env, s0)
    before = rk.LAUNCHES[key]
    split = rk.env_rollout(env, s0, h)(q0, qd0, acts, consts=consts)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[key] == before + 1
    lane = rk.env_rollout(env, s0, h, layout="lane")(q0, qd0, acts,
                                                     consts=consts)
    plain = rk.env_plain_rollout(env, s0, q0, qd0, acts)
    keep = torch.arange(n, device=dev) != 100
    for s, l, p in zip(split, lane, plain):
        assert _same_bits(s, l)
        assert _rel(s[keep], p[keep]) <= 1e-4
    assert bool(torch.isnan(split[0][100]).all())
    assert bool(torch.isfinite(split[0][keep]).all())

    action = acts[0, 0]
    before = rk.LAUNCHES[key]
    s_k, r_k = env.step(s0, action)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[key] == before + 1
    one = rk.env_rollout(env, s0, 1, layout="lane")(
        s0.physics.qpos[None], s0.physics.qvel[None], action[None, None],
        consts=consts)
    assert _same_bits(s_k.physics.qpos, one[1][0])
    assert _same_bits(s_k.physics.qvel, one[2][0])
    assert _same_bits(r_k.reshape(1), one[0][0])


# ---- the sharded entry -----------------------------------------------------------

@pytest.mark.parametrize("n_ranks", [4, 1])
def test_sharded_kernel_objective_equals_unsharded(n_ranks, tmp_path):
    """4 ranks (gloo where they share a card) and 1 rank (nccl), 250 and
    1000 lanes a rank, ragged against the 128-lane block: the gathered
    costs equal one unsharded launch's bit for bit, one launch a rank."""
    dev = _device()
    from ppi_tpu_torch.parallel import launch, spawn
    import torch_mesh_ranks
    door = Door(fixed_scene=True)
    s0 = door.reset(None, dev)
    acts = _acts(dev, 1000)
    # builds the body before the ranks start: no rank runs nvcc
    ref = rk.kernel_mpc_objective(door, s0, H)(None, acts)
    got = spawn(torch_mesh_ranks.card_objective_case, n_ranks,
                acts.cpu().numpy(), H, workdir=tmp_path)
    assert got["backend"] == launch.backend_for("cuda", n_ranks)
    assert got["launches"] == [1.0] * n_ranks
    assert got["agree"]
    assert torch.equal(torch.from_numpy(got["costs"]), ref.cpu())


def test_ball_in_a_cup_kernel_matches_plain_and_counts_its_launch():
    """The ball-in-a-cup kernel against its plain version on the card (64
    lanes, 3 + 5 + 2 steps, a NaN setpoint in lane 7), one counted launch;
    tolerances as ``chip_smoke.py``'s phase 39 (the states and the reward
    1e-4 of 1 + |plain|, the statistics 1e-3, the reaction 1e-2 N), the
    success flags equal."""
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    dev = _device()
    sim = BallInCupSim(stabilize_steps=3, cooldown_steps=2)
    rng = np.random.default_rng(5)
    a = np.zeros((64, 5, 4), np.float32)
    a[..., 0] = 0.4 * rng.standard_normal((64, 1))
    a[..., 1] = 1.5707 + 0.4 * rng.standard_normal((64, 1))
    a[..., 2:] = 3.0 * rng.standard_normal((64, 5, 2))
    a[7, 2, 0] = np.nan
    acts = torch.from_numpy(a).to(dev)
    q = torch.tensor([0.0, 0.0, 0.0, 1.5707], device=dev)
    key = bk.LAUNCH_KEYS[bk.route(sim)]
    before = rk.LAUNCHES[key]
    st, r, ok = bk.make_bic_rollout(sim)(q, acts)
    torch.cuda.synchronize()
    assert rk.LAUNCHES[key] == before + 1
    pst, pr, pok = bk.plain_bic_rollout(sim, q, acts)
    L = sim.layout
    assert torch.isnan(st).any(1).nonzero().flatten().tolist() == [7]
    assert torch.equal(torch.isnan(st), torch.isnan(pst))
    x, y = st.nan_to_num(0.0), pst.nan_to_num(0.0)
    assert _rel(x[:, :L.FORCE], y[:, :L.FORCE]) <= 1e-4
    assert _rel(x[:, L.MAX_POT:], y[:, L.MAX_POT:]) <= 1e-3
    assert float((x - y)[:, L.FORCE:L.MAX_POT].abs().max()) <= 1e-2
    assert _rel(r.nan_to_num(0.0), pr.nan_to_num(0.0)) <= 1e-4
    assert torch.equal(ok, pok)


def test_ball_in_a_cup_warp_layout_equals_the_thread_layout():
    """The warp layout (one warp a trajectory, the route) against the
    one-thread layout on the card: 96 lanes over 3 + 5 + 2 steps, a NaN
    setpoint in lane 7, bit for bit (the card's NaN is canonical, so the
    NaN lane too), one counted launch each."""
    from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
    from ppi_tpu_torch.envs.physics import bic_kernel as bk
    dev = _device()
    sim = BallInCupSim(stabilize_steps=3, cooldown_steps=2)
    rng = np.random.default_rng(6)
    a = np.zeros((96, 5, 4), np.float32)
    a[..., 0] = 0.4 * rng.standard_normal((96, 1))
    a[..., 1] = 1.5707 + 0.4 * rng.standard_normal((96, 1))
    a[..., 2:] = 3.0 * rng.standard_normal((96, 5, 2))
    a[7, 2, 0] = np.nan
    acts = torch.from_numpy(a).to(dev)
    q = torch.tensor([0.0, 0.0, 0.0, 1.5707], device=dev)
    assert bk.make_bic_rollout(sim).layout == "warp"
    keys = [bk.LAUNCH_KEYS[lay] for lay in ("thread", "warp")]
    before = [rk.LAUNCHES[k] for k in keys]
    got = {lay: bk.make_bic_rollout(sim, lay)(q, acts)
           for lay in ("thread", "warp")}
    torch.cuda.synchronize()
    assert [rk.LAUNCHES[k] for k in keys] == [b + 1 for b in before]
    assert torch.isnan(got["warp"][0]).any(1).nonzero().flatten().tolist() \
        == [7]
    for x, y in zip(got["warp"], got["thread"]):
        assert torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
