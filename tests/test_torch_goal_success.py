"""The port's evaluation runners against the JAX package's:
``goal_success`` (goal and scene sweeps), ``multi_start``, ``profile_mpc``,
``corl_curves``, ``run_sweep`` and ``utils.batch``.

The episodes are at smoke scale on the CPU (door-v0, T=3, H=4, N=8, one
warm-start iteration): torch and ``jax.random`` draw different numbers, so
an episode is held by the runner's own invariants (the goal constant within
an episode, every restart facing one scene) and by JAX's summary keys, not
by its bits. What is deterministic is held to JAX: the canonical configs
and the canonical agent's prior (1e-5 normwise; a Cholesky factor through
L L^T). A sweep split over two gloo ranks equals the unsplit one episode by
episode, bit for bit.
"""

import dataclasses
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from torch_helpers import to_np
import torch_mesh_ranks as ranks
import ppi_tpu.runners.goal_success as jax_gs
import ppi_tpu.runners.multi_start as jax_ms
from ppi_tpu_torch.parallel import spawn
from ppi_tpu_torch.runners import (
    corl_curves, goal_success as gs, multi_start as mst, profile_mpc,
    run_sweep)
from ppi_tpu_torch.runners.run_mpc import ENVS
from ppi_tpu_torch.utils import sweep
from ppi_tpu_torch.utils.batch import chunked_vmap

SMOKE = dict(timesteps=3, horizon=4, n_samples=8)
# the keys of JAX's goal_success.run summary and of each episode's entry
# (ppi_tpu/runners/goal_success.py:296-318), with restarts > 1
SUMMARY_KEYS = {"env", "config", "backend", "device", "resets",
                "goal_spread", "success_rate", "mean_return", "episodes",
                "restarts", "success_rate_any"}
EPISODE_KEYS = {"reset", "return", "success", "restart_returns",
                "restart_successes", "success_any", "goal"}
# JAX's multi_start.run summary (ppi_tpu/runners/multi_start.py:94-108)
# and the port's ``goal``
RESTART_KEYS = {"env", "config", "backend", "device", "restarts",
                "success_any", "n_success", "first_success", "returns",
                "best_return", "wall_s", "goal"}


def test_configs_are_jax_s():
    assert gs.CONFIGS == jax_gs.CONFIGS
    assert mst.CONFIGS == jax_ms.CONFIGS


@pytest.mark.parametrize("name", sorted(set(gs.CONFIGS) | set(mst.CONFIGS)))
def test_reset_state_has_the_goal_field(name):
    env = ENVS[name](**mst.CONFIGS.get(name, {}).get("env_kwargs", {}))
    state = env.reset(torch.Generator().manual_seed(0), "cpu")
    field = gs._goal_field(name)
    assert field == jax_gs._goal_field(name)
    assert getattr(state, field).dim() == 1   # a 2-D or 3-D goal


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.max(np.abs(b))), 1e-30)
    return float(np.max(np.abs(a - b))) / scale


@pytest.mark.parametrize("name", ["door-v0", "door-v0-hand", "pen-v0",
                                  "relocate-v0", "hammer-v0"])
def test_canonical_agent_prior_matches_jax(name):
    cfg, cfg_j = dict(gs.CONFIGS[name]), dict(jax_gs.CONFIGS[name])
    _, agent, policy = gs.build_canonical_agent(name, cfg, device="cpu")
    _, agent_j, policy_j = jax_gs.build_canonical_agent(name, cfg_j)
    assert cfg == cfg_j   # "4dt" resolved the same way, spec kept
    for field in ("timesteps", "horizon", "n_samples", "n_iters", "anneal",
                  "risk_quantile", "risk_weight", "use_map"):
        assert getattr(agent, field) == getattr(agent_j, field), field
    assert type(agent.solver).__name__ == type(agent_j.solver).__name__
    assert type(policy).__name__ == type(policy_j).__name__
    for f in dataclasses.fields(policy):
        x = getattr(policy, f.name)
        if not isinstance(x, torch.Tensor) or not x.numel():
            continue
        want = np.asarray(getattr(policy_j, f.name))
        if f.name.startswith("chol"):
            x, want = x @ x.T, want @ want.T
        assert _rel(to_np(x), want) <= 1e-5, f.name


@pytest.fixture(scope="module")
def sweep_2x2():
    return gs.run("door-v0", 2, warmstart=1, overrides=SMOKE, restarts=2,
                  device="cpu")


def test_goal_sweep_keeps_jax_s_summary_and_asserts(sweep_2x2):
    s = sweep_2x2
    assert set(s) == SUMMARY_KEYS
    assert all(set(ep) == EPISODE_KEYS for ep in s["episodes"])
    assert s["resets"] == 2 and s["restarts"] == 2
    assert s["backend"] == "cpu" and s["config"]["timesteps"] == 3
    assert s["goal_spread"] > 0.0   # two sampled frames
    for ep in s["episodes"]:
        assert len(ep["restart_returns"]) == 2
        assert np.isfinite(ep["return"])
    assert 0.0 <= s["success_rate"] <= s["success_rate_any"] <= 1.0
    json.dumps(s)


def test_goal_sweep_seeds_repeat_the_scene_across_restarts():
    keys = torch.stack([gs.seeds(0, 2).repeat_interleave(3),
                        gs.seeds(1, 6)], dim=1)
    assert keys.shape == (6, 2)
    assert torch.equal(keys[:3, 0], keys[0, 0].expand(3))
    assert len(set(keys[:, 1].tolist())) == 6
    assert not torch.equal(gs.seeds(0, 2), gs.seeds(1, 2))


def test_goal_sweep_over_two_ranks_equals_the_unsplit_one(sweep_2x2,
                                                          tmp_path):
    split = gs.run("door-v0", 2, warmstart=1, overrides=SMOKE, restarts=2,
                   mesh_devices=2, device="cpu")
    for a, b in zip(split["episodes"], sweep_2x2["episodes"]):
        assert a == b
    assert split["goal_spread"] == sweep_2x2["goal_spread"]


def test_chunked_and_sharded_vmap_equal_a_loop():
    keys = np.arange(3, dtype=np.int64)
    loop = [ranks._batch_fn(k) for k in torch.from_numpy(keys)]
    want = [torch.stack([r[i] for r in loop]) for i in range(3)]
    got = chunked_vmap(ranks._batch_fn, torch.from_numpy(keys), chunk=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    out, agree = spawn(ranks.sharded_vmap_case, 2, keys, device="cpu")
    assert agree
    for g, w in zip(out, want):
        assert g.dtype == to_np(w).dtype
        np.testing.assert_array_equal(g, to_np(w))


def test_multi_start_holds_the_task_and_varies_the_seed():
    s = mst.run("door-v0", 2, warmstart=1, overrides=SMOKE, device="cpu")
    assert set(s) == RESTART_KEYS
    assert s["restarts"] == 2 and len(s["returns"]) == 2
    state = ENVS["door-v0"]().reset(torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_allclose(s["goal"], to_np(state.frame), atol=1e-4)
    assert s["n_success"] == 0 or s["first_success"] is not None


def test_profile_mpc_times_one_triple():
    args = profile_mpc.build_parser().parse_args(
        ["--env", "pendulum", "--runs", "2", "--n-samples", "8",
         "--combos", "Lbps/SquaredExponentialKernel", "--device", "cpu"])
    out = profile_mpc.main(args)
    assert list(out["timings_s"]) == ["Lbps/SquaredExponentialKernel/n=8"]
    assert out["timings_s"]["Lbps/SquaredExponentialKernel/n=8"] > 0.0
    assert profile_mpc.build_parser().parse_args([]).device == "cuda"


def test_corl_curves_writes_the_overlay_and_resumes(tmp_path):
    argv = ["--env", "pendulum", "--seeds", "2", "--timesteps", "4",
            "--horizon", "4", "--n-samples", "16", "--device", "cpu"]
    rows = corl_curves.main(corl_curves.build_parser().parse_args(
        argv + ["--dir", str(tmp_path / "seq")]))
    assert list(rows) == ["iid", "gp-se", "rff"]
    assert all(r["n_seeds"] == 2 and np.isfinite(r["return_mean"])
               and np.isnan(r["success_rate"]) for r in rows.values())
    assert (tmp_path / "seq" / "overlay.png").stat().st_size > 0
    # --vmap-seeds runs the same episodes, seed for seed, in this process
    vmapped = corl_curves.main(corl_curves.build_parser().parse_args(
        argv + ["--dir", str(tmp_path / "vmap"), "--vmap-seeds"]))
    assert json.dumps(vmapped) == json.dumps(rows)
    # a resumed sweep reads every config from its checkpoint
    (tmp_path / "seq" / "overlay.png").unlink()
    resumed = corl_curves.main(corl_curves.build_parser().parse_args(
        argv + ["--dir", str(tmp_path / "seq"), "--resume",
                "--vmap-seeds"]))
    assert json.dumps(resumed) == json.dumps(rows)
    assert (tmp_path / "seq" / "overlay.png").stat().st_size > 0


def test_raster_overlay_writes_a_png_without_matplotlib(tmp_path,
                                                        monkeypatch):
    """The overlay a machine without matplotlib gets (the plotting
    backend's PIL stand-in): an RGB PNG whose pixels hold each curve's
    colour."""
    from PIL import Image
    from ppi_tpu_torch.utils import plotting
    monkeypatch.setattr(corl_curves, "pyplot", lambda: plotting.RASTER)
    t = np.arange(30)
    results = {label: [{"rewards": np.sin(t / (3 + i)) + 0.1 * k}
                       for k in range(2)]
               for i, label in enumerate(("iid", "gp-se", "rff"))}
    rows = {label: {"smoothness_mean": float(3 - i),
                    "smoothness_std": 0.1, "return_mean": 1.0,
                    "return_std": 0.5}
            for i, label in enumerate(results)}
    path = tmp_path / "overlay.png"
    corl_curves.plot_overlay(results, rows, path)
    img = np.asarray(Image.open(path))
    assert img.shape == (400, 1100, 3)
    pixels = {tuple(x) for x in img.reshape(-1, 3)}
    for colour in ("C0", "C1", "C2"):
        assert plotting.rgb(colour) in pixels


def test_runners_take_the_card_by_default_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for parser in (gs.build_parser(), mst.build_parser()):
        assert parser.parse_args(["--env", "door-v0"]).device == "cuda"
    assert corl_curves.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gs.main(["--env", "door-v0", "--resets", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mst.main(["--env", "door-v0", "--restarts", "1"])


@pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++")
                    is None, reason="no C++ toolchain")
def test_run_sweep_runs_two_commands(tmp_path):
    rows, code = sweep.run_sweep(["echo one", "sh -c 'exit 3'"],
                                 n_workers=2, workdir=tmp_path,
                                 logdir=tmp_path / "logs")
    assert code == 1
    assert [r["exit"] for r in rows] == [0, 3]
    assert "one" in (tmp_path / "logs" / "job_0_attempt1.log").read_text()
    assert sweep.BINARY.parent.name == "native"
    assert sweep.BINARY.parent.parent.name == "build"
    template, algorithms = run_sweep.GRIDS["mpc"]
    cmd = template.format(py=sys.executable, alg=algorithms[0], seed=0,
                          dir=tmp_path, device="cpu")
    assert "ppi_tpu_torch.runners.run_mpc" in cmd and "--device cpu" in cmd
