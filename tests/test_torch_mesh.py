"""The sharded entry: ``ppi_tpu_torch.parallel`` against the unsharded
port and against the JAX package's ``sharded_pallas_mpc_objective`` and
``Mpc(mesh=..., use_pallas=True)``.

One module-scoped fixture spawns one 4-rank gloo group on the CPU and runs
every rank-side case in it (``tests/torch_mesh_ranks.py``, which imports no
JAX); rank 0 returns numpy results. On the CPU each shard runs the plain
rollout, as the kernel's wrapper does for CPU tensors.

Tolerances. The port's sharded costs, agent steps and episodes equal the
port's unsharded ones bit for bit: a shard's lanes are computed as in the
whole batch and the gather adds only zeros. Against the JAX package:
1e-5 on the costs, the JAX package's own tolerance for its sharded
megakernel (``tests/test_pallas_rollout.py::TestShardedPallas``; XLA's and
torch's sin/cos/sqrt differ by a few ulps), and 1e-4 on the first action
after one Mppi iteration.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppi_tpu.policies.noise as jax_noise
import torch_helpers  # noqa: F401  (sets torch threads)
import torch_mesh_ranks as ranks
from ppi_tpu.algorithms import make_solver as jax_make_solver
from ppi_tpu.envs.base import batch_rollout as jax_batch_rollout
from ppi_tpu.envs.door import Door as JaxDoor
from ppi_tpu.envs.physics.pallas_rollout import sharded_pallas_mpc_objective
from ppi_tpu.mpc import Mpc as JaxMpc
from ppi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ppi_tpu.policies import design_moments as jax_design_moments
from ppi_tpu.policies import make_policy as jax_make_policy
from ppi_tpu_torch.mpc import Mpc
from ppi_tpu_torch.parallel import launch, make_mesh, spawn
from ppi_tpu_torch.parallel.mesh import Mesh

ROOT = Path(__file__).resolve().parents[1]
Q0 = np.array([0.0, 0.6, -0.8, 0.2], np.float32)  # door-v0's arm posture
MASK = np.array([1.0, 1.0, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    return dict(
        acts_a=(Q0 + 0.3 * rng.standard_normal((16, 3, 4))).astype(
            np.float32),
        acts_b=(Q0 + 0.3 * rng.standard_normal((8, 4, 4))).astype(
            np.float32),
        mask_b=MASK,
        z=rng.standard_normal((ranks.N, 3, 4)).astype(np.float32))


@pytest.fixture(scope="module")
def out(inputs, tmp_path_factory):
    return spawn(ranks.run_cases, 4, inputs["acts_a"], inputs["acts_b"],
                 inputs["mask_b"], inputs["z"], device="cpu",
                 workdir=tmp_path_factory.mktemp("mesh"))


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.fixture(scope="module")
def jax_door():
    env = JaxDoor(fixed_scene=True)
    return env, env.reset(jax.random.key(0))


# ---- (a)-(d): the objective ------------------------------------------

def test_group_is_gloo_on_the_cpu(out):
    assert out["backend"] == "gloo"


def test_sharded_kernel_objective_equals_unsharded_bit_for_bit(out):
    assert out["a_sharded"].shape == (16,)
    assert _same_bits(out["a_sharded"], out["a_unsharded"])
    assert out["a_ranks_agree"]


def test_eager_sharded_objective_equals_unsharded_bit_for_bit(out):
    assert _same_bits(out["a_eager_sharded"], out["a_eager"])


def test_sharded_objective_matches_jax_sharded_pallas(out, inputs,
                                                      jax_door):
    env, s0 = jax_door
    f = sharded_pallas_mpc_objective(env, s0, 3, jax_make_mesh(4),
                                     block=128, interpret=True)
    np.testing.assert_allclose(out["a_sharded"],
                               np.asarray(f(None, inputs["acts_a"])),
                               rtol=1e-5, atol=1e-5)


def test_nan_lane_poisons_only_its_own_lane(out):
    bad, good = out["a_nan"], out["a_unsharded"]
    assert np.isnan(bad[ranks.NAN_LANE])
    others = np.arange(16) != ranks.NAN_LANE
    assert _same_bits(bad[others], good[others])


def test_sharded_objective_with_mask_matches_jax_oracle(out, inputs,
                                                        jax_door):
    env, s0 = jax_door
    _, rew = jax_batch_rollout(env, s0, jnp.asarray(inputs["acts_b"]))
    np.testing.assert_allclose(
        out["b_sharded"], -(np.asarray(rew) * MASK[None, :]).sum(1),
        rtol=1e-5, atol=1e-5)


def test_uneven_batch_raises_divide(out):
    assert out["c_divide"] is not None and "divide" in out["c_divide"]


def test_make_mesh_with_too_few_ranks_raises(out):
    assert out["d_too_few"] is not None
    assert "n_devices=8" in out["d_too_few"] and "4 rank" in out["d_too_few"]


# ---- (e)-(g): the multislice mesh and the agent ----------------------

@pytest.mark.parametrize("axis", sorted(ranks.AXES))
def test_multislice_mesh_equals_unsharded(out, axis):
    assert _same_bits(out[f"e_{axis}"], out["a_unsharded"])
    assert _same_bits(out[f"e_{axis}_eager"], out["a_eager"])
    assert _same_bits(out[f"e_{axis}_action"], out["f_single_action"])
    assert _same_bits(out[f"e_{axis}_costs"], out["f_single_costs"])


def test_mesh_agent_control_step_equals_unsharded_bit_for_bit(out):
    assert _same_bits(out["f_mesh_costs"], out["f_single_costs"])
    assert _same_bits(out["f_mesh_action"], out["f_single_action"])
    mesh, single = out["f_mesh_policy"], out["f_single_policy"]
    assert sorted(mesh) == sorted(single)
    for k in single:
        assert _same_bits(mesh[k], single[k]), k


def test_mesh_agent_matches_jax_mesh_pallas_agent(out, inputs):
    """One Mppi + WhiteNoiseIid iteration with both packages' base draws
    pinned to one numpy array, against ``Mpc(mesh=make_mesh(4),
    use_pallas=True)`` (as ``TestShardedPallas`` runs it: unjitted, the
    kernel in interpret mode)."""
    env = JaxDoor(fixed_scene=True)
    mean, ci, co = jax_design_moments(env.action_low, env.action_high,
                                      ratio=1000.0)
    family, policy = jax_make_policy(
        "WhiteNoiseIid", env.dt * jnp.arange(3), env.action_dim, mean, ci,
        co, lower=env.action_low, upper=env.action_high)
    agent = JaxMpc(env=env, solver=jax_make_solver("Mppi", alpha=5.0),
                   family=family, timesteps=6, horizon=3,
                   n_samples=ranks.N, mesh=jax_make_mesh(4), use_pallas=True)
    z = jnp.asarray(inputs["z"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_noise.WhiteNoiseIid, "base_noise",
                   lambda self, state, key, n: z)
        carry, _, costs = agent.optimize(
            agent.init(policy, jax.random.key(0)),
            env.reset(jax.random.key(0)), 0, n_iters=1)
    np.testing.assert_allclose(out["f_mppi_mesh_costs"], np.asarray(costs),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["f_mppi_mesh_action"],
                               np.asarray(agent.action(carry)), atol=1e-4)
    assert _same_bits(out["f_mppi_mesh_costs"], out["f_mppi_single_costs"])
    assert _same_bits(out["f_mppi_mesh_action"],
                      out["f_mppi_single_action"])


def test_episode_replicas_agree_and_equal_unsharded(out):
    assert out["g_agree"]
    assert out["g_mesh_actions"].shape == (ranks.T, 4)
    assert _same_bits(out["g_mesh_actions"], out["g_single_actions"])


# ---- the launcher, the backend rule, the agent's device --------------

def test_spawn_fails_when_a_rank_raises(tmp_path):
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 failed"):
        spawn(ranks.fail_on_rank_one, 2, device="cpu", workdir=tmp_path)


def test_backend_rule(monkeypatch):
    assert launch.backend_for("cpu", 4) == "gloo"
    assert launch.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.backend_for("cuda", 4) == "nccl"   # a card a rank
    assert launch.backend_for("cuda", 8) == "gloo"   # ranks share cards
    assert launch.rank_device("cuda", 5) == torch.device("cuda", 1)


def test_no_card_raises_before_spawning():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(ranks.fail_on_rank_one, 2)


def test_make_mesh_joins_a_launchers_group():
    """Under torchrun (RANK and WORLD_SIZE set) make_mesh joins the
    launcher's group itself, by the backend rule; nothing is spawned."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    code = ("from ppi_tpu_torch.parallel import make_mesh\n"
            "m = make_mesh(1, device='cpu')\n"
            "print(m.backend, m.size(), m.device)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["gloo", "1", "cpu"]


def test_make_mesh_without_a_group_raises(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(4, device="cpu")


@pytest.mark.parametrize("mesh_device,agent_device", [
    ("cpu", "cuda"), ("cuda:0", "cuda:1"), ("cuda:0", "cpu")])
def test_mpc_on_another_device_than_the_mesh_rank_raises(mesh_device,
                                                         agent_device):
    mesh = Mesh(("samples",), (4,), 0, torch.device(mesh_device), "gloo",
                {})
    kw = dict(env=None, solver=None, family=None, timesteps=1, horizon=1,
              n_samples=4, mesh=mesh)
    with pytest.raises(ValueError, match="not the mesh rank's device"):
        Mpc(device=agent_device, **kw)
    assert Mpc(device=mesh_device, **kw).mesh is mesh
