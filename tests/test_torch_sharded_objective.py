"""The generic sharded objective (``parallel.sharded_objective``) with
``run_opt --mesh-devices`` and ``run_policy_search --mesh-devices``, on
gloo ranks on the CPU.

One module-scoped fixture spawns one 4-rank group and runs every rank-side
case in it (``tests/torch_mesh_ranks.py::sharded_objective_cases``, which
imports no JAX); rank 0 returns numpy results. Another test runs
``run_opt --mesh-devices 2`` through the runner, which starts its own two
ranks.

Tolerances. The sharded runs equal the unsharded ones bit for bit: the
costs, every stat of the trace, the final policy state and the generator's
state after the last iteration. NoisySphere draws its noise for all N
samples on every rank and computes all N costs before it keeps its rows
(``takes_rows``), so the generator advances as unsharded and a row's bits
do not depend on the shard. Against the JAX package's ``sharded_mpc_objective`` on
Pendulum: 1e-5, the JAX test's own (``tests/test_parallel.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
import torch_mesh_ranks as ranks
from ppi_tpu.envs.base import mpc_objective as jax_mpc_objective
from ppi_tpu.envs.classic import Pendulum as JaxPendulum
from ppi_tpu.parallel import make_mesh as jax_make_mesh
from ppi_tpu.parallel import sharded_objective as jax_sharded_objective
from ppi_tpu_torch.envs.base import mpc_objective
from ppi_tpu_torch.envs.classic import Pendulum
from ppi_tpu_torch.parallel import spawn
from ppi_tpu_torch.runners import run_opt, run_policy_search

OPT_ARGV = ["Reps", "NoisySphere", "--dimension", "5", "--n-iter", "12",
            "--device", "cpu", "mc", "--n-samples", "100"]
SEARCH_ARGV = ["Reps", "Test", "RbfFeatures", "--epsilon", "2.0",
               "--n-iters", "6", "--device", "cpu", "MonteCarlo",
               "--n-samples", "64"]


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.fixture(scope="module")
def acts():
    return (0.5 * np.random.default_rng(1).standard_normal(
        (32, 10, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def out(acts, tmp_path_factory):
    return spawn(ranks.sharded_objective_cases, 4, acts, OPT_ARGV,
                 SEARCH_ARGV, device="cpu",
                 workdir=tmp_path_factory.mktemp("sharded"))


def test_pendulum_objective_sharded_matches_unsharded_and_jax(out, acts):
    """``sharded_objective`` over Pendulum's eager MPC objective: bit for
    bit the unsharded objective; against JAX's sharded objective on its
    8-device CPU mesh, 1e-5."""
    assert out["ranks"] == 4
    env = Pendulum()
    local = mpc_objective(env, env.reset(None, "cpu"))(
        None, torch.from_numpy(acts)).numpy()
    assert _same_bits(out["pendulum"], local)
    jenv = JaxPendulum()
    js0 = jenv.reset(jax.random.key(0))
    f = jax_mpc_objective(jenv, js0)
    if len(jax.devices()) >= 8:
        f = jax_sharded_objective(f, jax_make_mesh(8))
    ref = np.asarray(jax.jit(lambda a: f(None, a))(jnp.asarray(acts)))
    np.testing.assert_allclose(out["pendulum"], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["opt", "search"])
def test_sharded_runs_equal_unsharded_bit_for_bit(out, case):
    """run_opt (NoisySphere, d=5, N=100, 12 iterations) and
    run_policy_search (TestEnv, N=64, 6 iterations) on 4 ranks: the final
    policy state, every stat of the trace and the generator's state equal
    the unsharded run's bit for bit, and every rank holds rank 0's
    state."""
    if case == "opt":
        state, trace, gen = run_opt.optimize(
            run_opt.build_parser().parse_args(OPT_ARGV))
    else:
        state, trace, gen, _ = run_policy_search.search(
            run_policy_search.build_parser().parse_args(SEARCH_ARGV))
    got = out[case]
    assert got["agree"]
    assert _same_bits(got["generator"], gen.get_state().numpy())
    assert sorted(got["trace"]) == sorted(trace)
    for k, v in trace.items():
        assert _same_bits(got["trace"][k], v.numpy()), k
    flat = ranks._flat(state)
    assert sorted(got["state"]) == sorted(flat)
    for k, v in flat.items():
        assert _same_bits(got["state"][k], v), k


@pytest.mark.parametrize("n,d", [(16, 5), (100, 5), (4096, 64), (6, 3)])
@pytest.mark.parametrize("world", [2, 4])
def test_noisy_sphere_rows_equal_the_unsharded_rows(n, d, world):
    """NoisySphere called with a rank's ``rows`` returns the unsharded
    costs' rows bit for bit and advances the generator as unsharded, at
    every shape: (16, 5) is one where the einsum's per-row result depends
    on the batch size on the CPU. Exact."""
    from ppi_tpu_torch.envs.functions import NoisySphere
    f = NoisySphere(dim=d)
    x = torch.from_numpy(np.random.default_rng(n + d).standard_normal(
        (n, d)).astype(np.float32))
    g_ref = torch.Generator().manual_seed(3)
    ref = f(g_ref, x).numpy()
    per = -(-n // world)
    for lo in range(0, n, per):
        hi = min(lo + per, n)
        g = torch.Generator().manual_seed(3)
        got = f(g, x, rows=(lo, hi)).numpy()
        assert _same_bits(got, ref[lo:hi]), (lo, hi)
        assert _same_bits(g.get_state().numpy(), g_ref.get_state().numpy())


def _runner_mesh_2(tmp_path, opt_argv):
    argv = opt_argv[:-3] + ["--dir", str(tmp_path), "--mesh-devices", "2",
                            *opt_argv[-3:]]
    state, trace = run_opt.main(run_opt.build_parser().parse_args(argv))
    ref_state, ref_trace, _ = run_opt.optimize(
        run_opt.build_parser().parse_args(opt_argv))
    for k, v in ref_trace.items():
        assert _same_bits(trace[k], v.numpy()), k
    assert _same_bits(state.mu.numpy(), ref_state.mu.numpy())
    assert _same_bits(state.sigma.numpy(), ref_state.sigma.numpy())
    run_dir = tmp_path / "Reps_NoisySphere_mc_0_"
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "args.json", "data.npz", "log"]
    assert (run_dir / "log").read_text().count("final cost") == 1


def test_run_opt_mesh_devices_2_through_the_runner(tmp_path):
    """``run_opt --mesh-devices 2`` starts two gloo ranks itself: the final
    state and trace equal the unsharded run's bit for bit, and rank 0 alone
    wrote the results."""
    _runner_mesh_2(tmp_path, OPT_ARGV)


def test_run_opt_mesh_devices_2_at_a_batch_of_16(tmp_path):
    """As above at N=16, d=5, a shape where a shard-sized einsum's rows
    differ from the full batch's on the CPU: still bit for bit."""
    _runner_mesh_2(tmp_path, OPT_ARGV[:-1] + ["16"])


def test_sharded_objective_raises_on_a_ragged_batch():
    """A batch that does not divide over the axis raises before any
    collective (a 3-rank mesh, N=4)."""
    from ppi_tpu_torch.parallel.mesh import Mesh, sharded_objective
    mesh = Mesh(("samples",), (3,), 0, torch.device("cpu"), "gloo", {})
    with pytest.raises(ValueError, match="divide"):
        sharded_objective(lambda g, a: a.sum(-1), mesh)(None,
                                                        torch.zeros(4, 2))
