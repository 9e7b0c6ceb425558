"""Rank side of tests/test_torch_mesh.py and
tests/test_torch_sharded_objective.py: every case, run once in each
process of one 4-rank gloo group on the CPU
(``ppi_tpu_torch.parallel.spawn``).

This module imports no JAX: the spawned children import it to find
``run_cases``. Rank 0 returns numpy results and the test compares them with
the port's unsharded path and with the JAX package.
"""

import dataclasses

import torch

import ppi_tpu_torch.policies.noise as noise
from ppi_tpu_torch.algorithms import make_solver
from ppi_tpu_torch.build import LAUNCHES
from ppi_tpu_torch.envs.base import mpc_objective
from ppi_tpu_torch.envs.door import Door
from ppi_tpu_torch.envs.physics.rollout_kernel import (
    kernel_mpc_objective, launch_key, sharded_kernel_mpc_objective)
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.parallel import (
    make_mesh, make_multislice_mesh, sharded_mpc_objective)
from ppi_tpu_torch.parallel.mesh import per_rank, replicas_agree
from ppi_tpu_torch.policies import design_moments, make_policy

# the Lbps + SE agent of tests/test_torch_mpc.py, on N=16 (4 a rank)
N, H, T, WARM = 16, 8, 3, 2
NAN_LANE = 9  # in rank 2's shard of the N=16 check (lanes 8-11)
AXES = {"flat": ("slices", "samples"), "samples": "samples"}


def _np(x):
    return x.detach().cpu().numpy()


def _value_error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def lbps_agent(env, mesh=None, axis="samples"):
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           1000.0)
    family, policy = make_policy(
        "SquaredExponentialKernel", env.dt * torch.arange(H), env.action_dim,
        mean, cov_in, cov_out, lengthscale=0.08, lower=env.action_low,
        upper=env.action_high, device="cpu")
    agent = Mpc(env=env, solver=make_solver("Lbps", delta=0.9),
                family=family, timesteps=T, horizon=H, n_samples=N,
                n_iters=2, anneal=0.5, device="cpu", mesh=mesh,
                mesh_axis=axis)
    return agent, agent.init(policy, torch.Generator().manual_seed(0))


def control_step(env, state, mesh=None, axis="samples"):
    """Warm start, then one control step: (action, costs, policy)."""
    agent, carry = lbps_agent(env, mesh, axis)
    carry, _ = agent.warm_start(carry, state, WARM)
    action, carry, stats = agent.control_step(carry, state, 0)
    return action, stats["costs"], carry.policy


def mppi_step(env, state, z, mesh=None):
    """One Mppi + WhiteNoiseIid iteration (H=3, T=6) with the base draws
    pinned to ``z``: (costs, first action)."""
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    family, policy = make_policy(
        "WhiteNoiseIid", env.dt * torch.arange(3), env.action_dim, mean,
        cov_in, cov_out, lower=env.action_low, upper=env.action_high,
        device="cpu")
    agent = Mpc(env=env, solver=make_solver("Mppi", alpha=5.0),
                family=family, timesteps=6, horizon=3, n_samples=N,
                device="cpu", mesh=mesh)
    carry = agent.init(policy, torch.Generator().manual_seed(0))
    normal = noise.WhiteNoiseIid._normal
    noise.WhiteNoiseIid._normal = lambda self, state, gen, n: \
        torch.from_numpy(z)
    try:
        carry, _, costs = agent.optimize(carry, state, 0, n_iters=1)
    finally:
        noise.WhiteNoiseIid._normal = normal
    return costs, agent.action(carry)


def _flat(policy):
    return {f.name: _np(getattr(policy, f.name))
            for f in dataclasses.fields(policy)
            if isinstance(getattr(policy, f.name), torch.Tensor)}


def run_cases(rank, acts_a, acts_b, mask_b, z):
    torch.set_num_threads(1)
    out = {}
    door = Door(fixed_scene=True)
    s0 = door.reset(None, "cpu")
    mesh = make_mesh(4, device="cpu")
    out["backend"] = mesh.backend

    # (a) the sharded objectives against the unsharded ones, N=16, H=3
    a = torch.from_numpy(acts_a)
    out["a_sharded"] = sharded_kernel_mpc_objective(door, s0, 3, mesh)(
        None, a)
    out["a_unsharded"] = kernel_mpc_objective(door, s0, 3)(None, a)
    out["a_eager_sharded"] = sharded_mpc_objective(door, s0, mesh)(None, a)
    out["a_eager"] = mpc_objective(door, s0)(None, a)
    bad = a.clone()
    bad[NAN_LANE, 0, 0] = torch.nan
    out["a_nan"] = sharded_kernel_mpc_objective(door, s0, 3, mesh)(None, bad)
    out["a_ranks_agree"] = replicas_agree(
        [out["a_sharded"], out["a_eager_sharded"]], mesh)

    # (b) N=8, H=4 with a horizon mask
    out["b_sharded"] = sharded_kernel_mpc_objective(
        door, s0, 4, mesh, torch.from_numpy(mask_b))(
            None, torch.from_numpy(acts_b))

    # (c) a batch that does not divide over the ranks; (d) too few ranks
    out["c_divide"] = _value_error(lambda: sharded_kernel_mpc_objective(
        door, s0, 3, mesh)(None, torch.zeros(10, 3, 4)))
    out["d_too_few"] = _value_error(lambda: make_mesh(8, device="cpu"))

    # (e) the 2x2 multislice mesh, the batch over both axes or the samples
    ms = make_multislice_mesh(2, 2, device="cpu")
    for key, axis in AXES.items():
        out[f"e_{key}"] = sharded_kernel_mpc_objective(
            door, s0, 3, ms, axis=axis)(None, a)
        out[f"e_{key}_eager"] = sharded_mpc_objective(
            door, s0, ms, axis=axis)(None, a)
        act, costs, _ = control_step(door, s0, ms, axis)
        out[f"e_{key}_action"], out[f"e_{key}_costs"] = act, costs

    # (f) one control step of the mesh agent against the unsharded agent,
    # and one Mppi iteration with pinned draws (against JAX's agent)
    for key, m in (("mesh", mesh), ("single", None)):
        act, costs, policy = control_step(door, s0, m)
        out[f"f_{key}_action"], out[f"f_{key}_costs"] = act, costs
        out[f"f_{key}_policy"] = _flat(policy)
        out[f"f_mppi_{key}_costs"], out[f"f_mppi_{key}_action"] = \
            mppi_step(door, s0, z, m)

    # (g) a T=3 episode: every rank's final policy state is rank 0's
    for key, m in (("mesh", mesh), ("single", None)):
        agent, carry = lbps_agent(door, m)
        carry, _ = agent.warm_start(carry, s0, WARM)
        carry, _, track = agent.run_episode(carry, s0)
        out[f"g_{key}_actions"] = track["action"]
        if m is not None:
            out["g_agree"] = replicas_agree(carry.policy, mesh)

    return {k: _np(v) if isinstance(v, torch.Tensor) else v
            for k, v in out.items()} if rank == 0 else None


def fail_on_rank_one(rank):
    if rank == 1:
        raise RuntimeError("rank 1 failed")
    return rank


def card_objective_case(rank, acts, horizon):
    """The sharded kernel objective on the card (door-v0, the nominal
    frame): rank 0 returns the costs, the backend, each rank's launches of
    door-v0's layout and whether every rank gathered the same costs."""
    mesh = make_mesh()
    door = Door(fixed_scene=True)
    s0 = door.reset(None, mesh.device)
    key = launch_key(door)
    before = LAUNCHES[key]
    costs = sharded_kernel_mpc_objective(door, s0, horizon, mesh)(
        None, torch.from_numpy(acts).to(mesh.device))
    launches = per_rank(LAUNCHES[key] - before, mesh)
    agree = replicas_agree(costs, mesh)
    if rank:
        return None
    return dict(costs=_np(costs), backend=mesh.backend, launches=launches,
                agree=agree)


def sharded_objective_cases(rank, acts, opt_argv, search_argv):
    """The generic ``sharded_objective`` (tests/test_torch_sharded_objective
    .py) on every rank of one gloo group: Pendulum's eager MPC objective on
    ``acts``, a run_opt optimization and a TestEnv policy search, each
    sharded over the group. Rank 0 returns numpy results, with each run's
    generator state after its last iteration."""
    from ppi_tpu_torch.envs.base import mpc_objective as eager_objective
    from ppi_tpu_torch.envs.classic import Pendulum
    from ppi_tpu_torch.parallel import sharded_objective
    from ppi_tpu_torch.runners import run_opt, run_policy_search
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = {"ranks": mesh.size()}
    env = Pendulum()
    f = eager_objective(env, env.reset(None, "cpu"))
    out["pendulum"] = sharded_objective(f, mesh)(None, torch.from_numpy(acts))
    state, trace, gen = run_opt.optimize(
        run_opt.build_parser().parse_args(opt_argv), mesh)
    out["opt"] = dict(state=_flat(state), trace=trace,
                      generator=gen.get_state(),
                      agree=replicas_agree(state, mesh))
    policy, trace, gen, _ = run_policy_search.search(
        run_policy_search.build_parser().parse_args(search_argv), mesh)
    out["search"] = dict(state=_flat(policy), trace=trace,
                         generator=gen.get_state(),
                         agree=replicas_agree(policy, mesh))
    if rank:
        return None

    def numpy_tree(x):
        if isinstance(x, dict):
            return {k: numpy_tree(v) for k, v in x.items()}
        return _np(x) if isinstance(x, torch.Tensor) else x

    return numpy_tree(out)


def _batch_fn(key):
    """A per-key result of every kind the episode runners gather: a
    scalar, a flag and a vector (``tests/test_torch_goal_success.py``)."""
    k = float(key)
    return (torch.tensor(k * 1.5 - 2.0), torch.tensor(int(key) % 2 == 1),
            torch.tensor([k, -k, k * k]))


def sharded_vmap_case(rank, keys):
    """``utils.batch.sharded_vmap`` of ``_batch_fn`` over a 2-rank gloo
    group on the CPU; rank 0 returns numpy results."""
    from ppi_tpu_torch.utils.batch import sharded_vmap
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = sharded_vmap(_batch_fn, torch.from_numpy(keys), mesh)
    agree = replicas_agree(list(out), mesh)
    return ([_np(x) for x in out], agree) if rank == 0 else None
