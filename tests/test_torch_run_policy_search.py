"""The episodic policy-search runner (``runners/run_policy_search.py``) on
the CPU: its results on disk against the JAX runner's keys, ``--resume``
against an uninterrupted run, its flags, and no path off the card when
the card is asked for.

A resumed run equals the uninterrupted one bit for bit: the checkpoint
holds the policy state and the generator's state, so the resumed
iterations draw what the uninterrupted run drew.
"""

import json

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
import torch_mesh_ranks as ranks
from ppi_tpu_torch.runners import run_policy_search as rps

BASE = ["Reps", "Test", "RbfFeatures", "--epsilon", "2.0"]
SAMPLING = ["--device", "cpu", "MonteCarlo", "--n-samples", "32"]


def _args(*extra):
    return rps.build_parser().parse_args(BASE + list(extra) + SAMPLING)


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_results_directory_matches_the_jax_runner(tmp_path):
    """``--dir`` writes ``args.json``, the ``log`` and ``data.npz`` with the
    JAX runner's keys (the solver's trace, ``episodes`` and
    ``success_rate``) under the JAX runner's directory name; a second run
    there stops unless ``--force``."""
    import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, conftest)
    from ppi_tpu.runners import run_policy_search as jax_rps
    argv = BASE + ["--n-iters", "3", "--dir", str(tmp_path), "--name", "x"]
    policy, trace, success = rps.main(
        rps.build_parser().parse_args(argv + SAMPLING))
    out = tmp_path / "Reps_Test_RbfFeatures_MonteCarlo_0_x"
    assert json.loads((out / "args.json").read_text())["env"] == "Test"
    assert (out / "log").read_text().count("iter ") == 3
    data = np.load(out / "data.npz")
    jax_dir = tmp_path / "jax"
    jax_rps.main(jax_rps.build_parser().parse_args(
        BASE + ["--n-iters", "3", "--dir", str(jax_dir), "--name", "x",
                "MonteCarlo", "--n-samples", "32"]))
    jdata = np.load(jax_dir / out.name / "data.npz")
    assert sorted(data.files) == sorted(jdata.files)
    np.testing.assert_array_equal(data["episodes"], [0, 32, 64])
    np.testing.assert_array_equal(data["success_rate"], success)
    assert len(success) == 3
    assert rps.main(rps.build_parser().parse_args(argv + SAMPLING)) is None


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Four iterations with a checkpoint every two, then ``--resume`` to
    eight: the final policy state, the generator's state and the resumed
    iterations' trace equal an uninterrupted eight-iteration run's bit for
    bit."""
    d = str(tmp_path)
    rps.main(_args("--n-iters", "4", "--checkpoint-every", "2", "--dir", d))
    assert (tmp_path / "Reps_Test_RbfFeatures_MonteCarlo_0_"
            / "checkpoint.npz").exists()
    policy, trace, gen, start = rps.search(
        _args("--n-iters", "8", "--resume", "--dir", d))
    ref_policy, ref_trace, ref_gen, ref_start = rps.search(
        _args("--n-iters", "8"))
    assert (start, ref_start) == (4, 0)
    assert _same_bits(gen.get_state().numpy(), ref_gen.get_state().numpy())
    for k, v in ref_trace.items():
        assert _same_bits(trace[k].numpy(), v[4:].numpy()), k
    for k, v in ranks._flat(ref_policy).items():
        assert _same_bits(ranks._flat(policy)[k], v), k


def test_diagnostics_and_string_resolution_flags():
    """``--track-diagnostics`` records the prior's entropy (0 without it);
    ``--n-string-particles`` gives the ball-in-a-cup env a sim of that
    resolution (its kernel body is generated for it)."""
    _, trace, _ = rps.main(_args("--n-iters", "2"))
    _, tracked, _ = rps.main(_args("--n-iters", "2", "--track-diagnostics"))
    assert float(trace["ent"].max()) == 0.0
    assert np.all(tracked["ent"] != 0.0)
    args = rps.build_parser().parse_args(
        ["Reps", "BallInACup", "RbfFeatures", "--n-string-particles", "24",
         "MonteCarlo"])
    env = rps.make_env(args)
    assert env.sim.n_particles == 24
    assert env.sim._effective_pbd_iterations == 60
    assert args.device == "cuda" and args.n_samples == 10
    assert args.mesh_devices == 0 and args.n_iters == 50


def test_the_card_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = rps.build_parser().parse_args(
        ["Reps", "BallInACup", "RbfFeatures", "MonteCarlo"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rps.main(args)
