"""The runners' plot and render flags on the CPU at tiny sizes: each writes
the files the JAX runner's flags write (``ppi_tpu/runners/run_mpc.py``
:277-281, 349-405; ``run_opt.py``:109-111; ``run_policy_search.py``
:141-161), named as there."""

from pathlib import Path

import pytest
import torch
from PIL import Image

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
from ppi_tpu_torch.envs.episodic import BallInACup
from ppi_tpu_torch.runners import run_mpc, run_opt
from ppi_tpu_torch.runners import run_policy_search as rps
from ppi_tpu_torch.utils.video import read_avi_frames

MPC_PLOTS = {"result_warmup.png", "observation_sequence.png",
             "action_sequence_all.png", "ess_history.png",
             "alpha_history.png", "smoothness.png"}
RESULTS = {"args.json", "log", "data.npz"}


def _mpc(tmp_path, *flags, env="door-v0"):
    args = run_mpc.build_parser().parse_args(
        ["Lbps", env, "SquaredExponentialKernel", "--timesteps", "3",
         "--horizon", "2", "--n-warmstart-iters", "1", "--dir",
         str(tmp_path), *flags, "--device", "cpu", "MonteCarlo",
         "--n-samples", "8"])
    run_mpc.main(args)
    (run,) = Path(tmp_path).iterdir()
    return run


@pytest.mark.parametrize("fmt, written, plots", [
    ("gif", "episode.gif", MPC_PLOTS), ("mp4", "episode.avi", set())])
def test_run_mpc_render_flags_write_the_episode(tmp_path, fmt, written,
                                                plots):
    """``--render --render-3d --video-format F``: the schematic (an mp4
    without an ffmpeg backend is written as avi, as the JAX runner does),
    the ray-cast GIF (a frame a step) and the plots unless
    ``--no-plots``."""
    run = _mpc(tmp_path, "--render", "--render-3d", "--video-format", fmt,
               *([] if plots else ["--no-plots"]))
    names = {p.name for p in run.iterdir()}
    assert names == RESULTS | plots | {written, "episode_3d.gif"}
    path = run / written
    n = (len(read_avi_frames(path)) if path.suffix == ".avi"
         else Image.open(path).n_frames)
    assert n == 2                       # 3 steps at stride 2
    with Image.open(run / "episode_3d.gif") as im:
        assert im.n_frames == 3 and im.size == (320, 240)
    assert "rendering failed" not in (run / "log").read_text()


def test_run_mpc_renders_a_planar_env(tmp_path):
    """An env without a render of its own gets ``render_planar``."""
    run = _mpc(tmp_path, "--no-plots", "--render", env="cheetah")
    assert {p.name for p in run.iterdir()} == RESULTS | {"episode.gif"}
    assert "rendered" in (run / "log").read_text()


def test_run_opt_plot(tmp_path):
    args = run_opt.build_parser().parse_args(
        ["Reps", "NoisySphere", "--n-iter", "4", "--plot", "--dir",
         str(tmp_path), "--device", "cpu", "mc", "--n-samples", "20"])
    run_opt.main(args)
    (run,) = Path(tmp_path).iterdir()
    assert {p.name for p in run.iterdir()} == RESULTS | {"result.png"}


def test_run_policy_search_render_and_plot(tmp_path, monkeypatch):
    """``--render --plot`` on a short ball-in-a-cup (2 + 5 + 3 steps): the
    traced mean trajectory's GIF at stride 8, the trace and the prior's
    samples."""
    monkeypatch.setattr(rps, "make_env", lambda args: BallInACup(
        sim=BallInCupSim(stabilize_steps=2, cooldown_steps=3),
        time_horizon=0.01))
    args = rps.build_parser().parse_args(
        ["Reps", "BallInACup", "RbfFeatures", "--n-iters", "1", "--render",
         "--plot", "--dir", str(tmp_path), "--device", "cpu", "MonteCarlo",
         "--n-samples", "4"])
    traced = []
    rps.main(args, on_trace=lambda *a: traced.append(a))
    (run,) = Path(tmp_path).iterdir()
    assert {p.name for p in run.iterdir()} == RESULTS | {
        "ball_in_a_cup.gif", "result.png", "policy_samples.png"}
    # the hook saw the traced mean trajectory; its final state is what the
    # kernel's plain version computes for the same setpoints
    (path, actions, qh, ph, final), = traced
    env = rps.make_env(args)
    state, _, success = env.rollout()(env.q_start, actions[None])
    assert path == run / "ball_in_a_cup.gif" and qh.shape == (8, 4)
    want = state[0]
    got = torch.stack(env.sim.scalars(final), -1)
    assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs()))
                [torch.isfinite(want)].all())
    assert bool(env.sim.reward_and_success(final)[1]) == bool(success[0])
    with Image.open(run / "ball_in_a_cup.gif") as im:
        assert im.n_frames == 1          # 5 + 3 steps at stride 8
    assert "rendered mean trajectory" in (run / "log").read_text()
