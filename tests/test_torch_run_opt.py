"""The port's black-box optimization runner, end to end on the CPU.

The canonical run (``make opt``: Reps, NoisySphere, d=20, 100 Monte Carlo
samples, 50 iterations, seed 0) goes from a first-iteration cost of about
540-600 to below 100; the JAX package reaches 42.6 from 537.0 with its own
random numbers. Every solver of the registry runs with every sampler.
"""

import json

import numpy as np
import pytest

from ppi_tpu_torch.algorithms import ALGORITHMS
from ppi_tpu_torch.runners import run_opt


def _run(*argv):
    return run_opt.main(run_opt.build_parser().parse_args(list(argv)))


def test_canonical_run_converges():
    state, trace = _run("Reps", "NoisySphere", "--dimension", "20",
                        "--device", "cpu", "mc", "--n-samples", "100")
    assert trace["mean"].shape == (50,)
    assert trace["mean"][0] > 300.0 and trace["mean"][-1] < 100.0
    assert np.isfinite(state.mu.numpy()).all()


def test_result_directory_and_exists_guard(tmp_path, capsys):
    argv = ("Cem", "Rosenbrock", "--dimension", "3", "--n-iter", "4",
            "--dir", str(tmp_path), "--device", "cpu", "mc", "--n-samples",
            "32")
    _, trace = _run(*argv)
    out = tmp_path / "Cem_Rosenbrock_mc_0_"
    args = json.loads((out / "args.json").read_text())
    assert args["algorithm"] == "Cem" and args["device"] == "cpu"
    data = np.load(out / "data.npz")
    np.testing.assert_array_equal(data["mean"], trace["mean"])
    np.testing.assert_array_equal(data["episodes"], 32 * np.arange(4))
    assert "final cost" in (out / "log").read_text()
    assert _run(*argv) is None
    assert "experiment done!" in capsys.readouterr().out


@pytest.mark.parametrize("sampler", ["mc", "qmc", "quad"])
@pytest.mark.parametrize("algorithm", sorted(ALGORITHMS))
def test_every_solver_and_sampler_runs(algorithm, sampler):
    state, trace = _run(algorithm, "NoisySphere", "--dimension", "4",
                        "--n-iter", "3", "--n-elites", "5", "--device",
                        "cpu", sampler, "--n-samples", "16")
    assert trace["mean"].shape == (3,)
    assert np.isfinite(trace["mean"]).all()
    assert np.isfinite(state.mu.numpy()).all()


@pytest.mark.parametrize("function", ["Himmelblau", "Rastrigin",
                                      "Styblinski"])
def test_functions_without_a_seed_run(function):
    """The runner passes --seed to the function; only NoisySphere takes
    one, so make_function keeps only the settings a function declares."""
    _, trace = _run("Reps", function, "--dimension", "2", "--n-iter", "3",
                    "--device", "cpu", "mc", "--n-samples", "16")
    assert np.isfinite(trace["mean"]).all()
