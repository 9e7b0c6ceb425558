"""``run_mpc --checkpoint-every/--resume`` and the episode track's
``costs`` in the port.

door-v0 at T=6 (N=8, H=4, one warm-start iteration, Lbps with two
iterations a step) on the CPU: an episode checkpointed every 2 steps and
stopped after the checkpoint at step 4, as a crash would stop it, then
resumed, equals the uninterrupted episode bit for bit: the track, the final
env state, the policy state and the generator's state. The port saves the
generator's state, so nothing is redrawn on resume. ``collect=True`` adds
the (T, N) costs that JAX's ``run_episode_scan(collect=True)`` adds (held
on the pendulum, whose JAX episode compiles in seconds).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu_torch.runners import run_mpc

ARGV = ["Lbps", "door-v0", "SquaredExponentialKernel", "--delta", "0.9",
        "--n-iters", "2", "--anneal", "0.5", "--lengthscale", "0.08",
        "--timesteps", "6", "--horizon", "4", "--n-warmstart-iters", "1",
        "--seed", "3", "--device", "cpu"]
TAIL = ["MonteCarlo", "--n-samples", "8"]
CKPT = ["--checkpoint-every", "2"]


class Crash(Exception):
    pass


def _args(*extra):
    return run_mpc.build_parser().parse_args(ARGV + list(extra) + TAIL)


def _bits(x):
    return x.contiguous().view(torch.int32) if x.is_floating_point() else x


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _tensors(tree):
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)}


def _crash_after(step):
    def hook(t, carry, env_state):
        if t == step:
            raise Crash
    return hook


def _resume(dirname):
    end, steps = {}, []
    ret, success, track = run_mpc.main(
        _args("--dir", str(dirname), *CKPT, "--resume"),
        lambda t, state, row: steps.append(t),
        on_checkpoint=lambda t, c, es: end.update(t=t, carry=c, state=es))
    end["steps"] = steps
    return ret, track, end


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted episode, and the same one stopped after the
    checkpoint at step 4 (the experiment dir copied there) and resumed."""
    agent, carry, state = run_mpc.setup(_args())
    carry, _ = agent.warm_start(carry, state, 1)
    carry, state, track = agent.run_episode(carry, state)
    ref = dict(carry=carry, state=state, track=track)
    base = tmp_path_factory.mktemp("resume")
    with pytest.raises(Crash):
        run_mpc.main(_args("--dir", str(base), *CKPT),
                     on_checkpoint=_crash_after(4))
    (run,) = base.iterdir()
    crashed = base.parent / "crashed"
    shutil.copytree(run, crashed)
    ret, track, end = _resume(base)
    return dict(ref=ref, run=run, crashed=crashed, ret=ret, track=track,
                end=end)


def test_stopped_run_left_its_checkpoint_and_track(runs):
    data = np.load(runs["crashed"] / "episode_track.npz")
    assert sorted(data.files) == ["action", "alpha", "ess", "obs", "qpos",
                                  "reward"]
    assert all(len(data[k]) == 4 for k in data.files)
    assert int(np.load(runs["crashed"] / "episode_checkpoint.npz")
               ["__step"]) == 4
    assert not (runs["crashed"] / "data.npz").exists()


def test_resumed_episode_equals_the_uninterrupted_one_bit_for_bit(runs):
    ref, track, end = runs["ref"], runs["track"], runs["end"]
    assert end["t"] == 6 and end["steps"] == [4, 5]   # the callback too
    assert sorted(track) == sorted(ref["track"])
    for k in track:
        assert _same(track[k], ref["track"][k]), k
    assert runs["ret"] == float(ref["track"]["reward"].sum())
    for name, x in _tensors(ref["state"].physics).items():
        assert _same(getattr(end["state"].physics, name), x), name
    assert _same(end["state"].frame, ref["state"].frame)
    for name, x in _tensors(ref["carry"].policy).items():
        assert _same(getattr(end["carry"].policy, name), x), name
    assert torch.equal(end["carry"].generator.get_state(),
                       ref["carry"].generator.get_state())
    assert end["carry"].window == ref["carry"].window == 5
    data = np.load(runs["run"] / "data.npz")
    np.testing.assert_array_equal(data["actions"],
                                  ref["track"]["action"].numpy())


def test_extra_track_rows_past_the_checkpoint_are_trimmed(runs, tmp_path):
    """A crash between the track write and the checkpoint write: the track
    holds all 6 steps, the checkpoint says 4; the resumed run drops rows 4-5
    and replays them to the same bits."""
    run = tmp_path / runs["run"].name
    shutil.copytree(runs["crashed"], run)
    full = np.load(runs["run"] / "episode_track.npz")
    np.savez(run / "episode_track.npz",
             **{k: full[k] + 1.0 for k in full.files})
    ret, track, _ = _resume(tmp_path)
    np.testing.assert_array_equal(track["action"][:4].numpy(),
                                  full["action"][:4] + 1.0)
    for k in track:
        assert _same(track[k][4:], runs["ref"]["track"][k][4:]), k
    # and with the rows as the crash left them, the whole track is equal
    shutil.copy(runs["run"] / "episode_track.npz", run / "episode_track.npz")
    shutil.copy(runs["crashed"] / "episode_checkpoint.npz", run)
    ret, track, _ = _resume(tmp_path)
    assert ret == runs["ret"]
    for k in track:
        assert _same(track[k], runs["ref"]["track"][k]), k


def test_resume_without_a_track_file_fails_as_jax_does(runs, tmp_path):
    run = tmp_path / runs["run"].name
    shutil.copytree(runs["crashed"], run)
    (run / "episode_track.npz").unlink()
    with pytest.raises(SystemExit,
                       match="checkpoint at step 4 but .* is missing"):
        _resume(tmp_path)


def test_collect_adds_the_costs_as_jax_does():
    from ppi_tpu.algorithms import make_solver as jax_solver
    from ppi_tpu.envs.classic import Pendulum as JaxPendulum
    from ppi_tpu.mpc import Mpc as JaxMpc
    from ppi_tpu.policies import design_moments as jax_moments
    from ppi_tpu.policies import make_policy as jax_policy
    T, H, N = 3, 4, 8
    env = JaxPendulum()
    fam, pol = jax_policy("WhiteNoiseIid", env.dt * jnp.arange(H), 1,
                          *jax_moments(env.action_low, env.action_high,
                                       ratio=1000.0),
                          lower=env.action_low, upper=env.action_high)
    agent = JaxMpc(env=env, solver=jax_solver("Mppi", alpha=10.0),
                   family=fam, timesteps=T, horizon=H, n_samples=N)
    carry = agent.init(pol, jax.random.key(0))
    want = {c: agent.run_episode_scan(carry, env.reset(jax.random.key(0)),
                                      collect=c)[2]
            for c in (False, True)}
    args = run_mpc.build_parser().parse_args(
        ["Mppi", "pendulum", "WhiteNoiseIid", "--alpha", "10",
         "--timesteps", str(T), "--horizon", str(H), "--device", "cpu",
         "MonteCarlo", "--n-samples", str(N)])
    got = {}
    for c in (False, True):
        agent_t, carry_t, state_t = run_mpc.setup(args)
        got[c] = agent_t.run_episode(carry_t, state_t, collect=c)[2]
    assert sorted(got[False]) == sorted(want[False])
    assert sorted(got[True]) == sorted(want[True]) == sorted(
        [*want[False], "costs"])
    for k, v in want[True].items():
        assert tuple(got[True][k].shape) == v.shape, k
    assert got[True]["costs"].shape == (T, N)
    # the costs of step t are the planner's last iteration at that step
    agent_t, carry_t, state_t = run_mpc.setup(args)
    _, _, stats = agent_t.control_step(carry_t, state_t, 0)
    assert torch.equal(got[True]["costs"][0], stats["costs"])
    for k in got[False]:
        assert torch.equal(got[True][k], got[False][k]), k
