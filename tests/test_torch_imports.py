"""Import hygiene and the no-fallback rule of the torch port."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "ppi_tpu_torch",
    "ppi_tpu_torch.build",
    "ppi_tpu_torch.convert",
    "ppi_tpu_torch.datasets",
    "ppi_tpu_torch.model_selection",
    "ppi_tpu_torch.samplers",
    "ppi_tpu_torch.envs.base",
    "ppi_tpu_torch.envs.classic",
    "ppi_tpu_torch.envs.ball_in_a_cup",
    "ppi_tpu_torch.envs.episodic",
    "ppi_tpu_torch.envs.door",
    "ppi_tpu_torch.envs.hand",
    "ppi_tpu_torch.envs.door_hand",
    "ppi_tpu_torch.envs.door_adroit",
    "ppi_tpu_torch.envs.pen",
    "ppi_tpu_torch.envs.relocate",
    "ppi_tpu_torch.envs.cheetah",
    "ppi_tpu_torch.envs.hammer",
    "ppi_tpu_torch.envs.pen_hand",
    "ppi_tpu_torch.envs.relocate_hand",
    "ppi_tpu_torch.envs.hammer_hand",
    "ppi_tpu_torch.envs.pen_adroit",
    "ppi_tpu_torch.envs.relocate_adroit",
    "ppi_tpu_torch.envs.hammer_adroit",
    "ppi_tpu_torch.envs.reacher",
    "ppi_tpu_torch.envs.finger",
    "ppi_tpu_torch.envs.push",
    "ppi_tpu_torch.envs.fetch_pick",
    "ppi_tpu_torch.envs.hopper",
    "ppi_tpu_torch.envs.walker",
    "ppi_tpu_torch.envs.standup",
    "ppi_tpu_torch.envs.physics",
    "ppi_tpu_torch.envs.physics.engine",
    "ppi_tpu_torch.envs.physics.engine_soa",
    "ppi_tpu_torch.envs.physics.scalar_math",
    "ppi_tpu_torch.envs.physics.rollout_kernel",
    "ppi_tpu_torch.envs.physics.warp_layout",
    "ppi_tpu_torch.envs.physics.split_layout",
    "ppi_tpu_torch.envs.physics.bic_kernel",
    "ppi_tpu_torch.envs.physics.ik_kernel",
    "ppi_tpu_torch.envs.physics.mjcf",
    "ppi_tpu_torch.envs.functions",
    "ppi_tpu_torch.ops",
    "ppi_tpu_torch.ops.cuda_ops",
    "ppi_tpu_torch.ops.divergences",
    "ppi_tpu_torch.ops.fftnoise",
    "ppi_tpu_torch.ops.qmc",
    "ppi_tpu_torch.policies",
    "ppi_tpu_torch.policies.features",
    "ppi_tpu_torch.policies.kernels",
    "ppi_tpu_torch.policies.gaussian",
    "ppi_tpu_torch.policies.noise",
    "ppi_tpu_torch.algorithms",
    "ppi_tpu_torch.mpc",
    "ppi_tpu_torch.mpc.metrics",
    "ppi_tpu_torch.parallel",
    "ppi_tpu_torch.parallel.launch",
    "ppi_tpu_torch.parallel.mesh",
    "ppi_tpu_torch.utils",
    "ppi_tpu_torch.utils.batch",
    "ppi_tpu_torch.utils.device",
    "ppi_tpu_torch.utils.sweep",
    "ppi_tpu_torch.utils.plotting",
    "ppi_tpu_torch.utils.video",
    "ppi_tpu_torch.viz",
    "ppi_tpu_torch.render",
    "ppi_tpu_torch.render3d",
    "ppi_tpu_torch.runners.animations",
    "ppi_tpu_torch.runners.figures",
    "ppi_tpu_torch.runners.collect_expert",
    "ppi_tpu_torch.runners.corl_curves",
    "ppi_tpu_torch.runners.goal_success",
    "ppi_tpu_torch.runners.multi_start",
    "ppi_tpu_torch.runners.profile_mpc",
    "ppi_tpu_torch.runners.run_mpc",
    "ppi_tpu_torch.runners.run_sweep",
    "ppi_tpu_torch.runners.run_opt",
    "ppi_tpu_torch.runners.run_policy_search",
    "ppi_tpu_torch.runners.train_sac_expert",
    "ppi_tpu_torch.studies.body_report",
    "ppi_tpu_torch.studies.episode_trace",
    "ppi_tpu_torch.studies.fma_contraction",
    "ppi_tpu_torch.studies.moment_match",
    "ppi_tpu_torch.studies.render_phases",
    "ppi_tpu_torch.studies.replan_trace",
    "ppi_tpu_torch.studies.seed_sweep",
    "ppi_tpu_torch.studies.split_layout",
    "ppi_tpu_torch.studies.warp_layout",
]


def test_port_imports_neither_jax_nor_flax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'ppi_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_the_card():
    """A caller who names no device gets the card: the library entry
    points' defaults, read from their signatures (no card needed)."""
    import dataclasses
    import inspect
    from ppi_tpu_torch.mpc import Mpc
    from ppi_tpu_torch.policies import make_policy
    fields = {f.name: f.default for f in dataclasses.fields(Mpc)}
    assert fields["device"] == "cuda"
    assert inspect.signature(make_policy).parameters["device"].default \
        == "cuda"
    from ppi_tpu_torch.parallel import (
        make_mesh, make_multislice_mesh, spawn)
    for fn in (make_mesh, make_multislice_mesh, spawn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # a helper that makes a tensor takes its device from the caller: no
    # default names the CPU
    from ppi_tpu_torch.envs.functions import NoisySphere
    device = inspect.signature(NoisySphere.quadratic).parameters["device"]
    assert device.default is inspect.Parameter.empty
    assert NoisySphere(dim=3).quadratic("cpu").shape == (3, 3)


def test_make_policy_accepts_every_name_of_the_registry():
    """All 13 names build on the CPU and draw samples of the right shape;
    the feature families' weights have their own width."""
    from ppi_tpu_torch.policies import POLICY_NAMES, make_policy
    assert len(POLICY_NAMES) == 13
    h, d = 6, 2
    for name in POLICY_NAMES:
        fam, state = make_policy(
            name, 0.02 * torch.arange(h), d, torch.zeros(d),
            torch.full((1,), 10.0), 0.1 * torch.eye(d), lengthscale=0.05,
            period=0.02, n_features=4, order=2, beta=0.5, device="cpu")
        xs, params = fam.sample(state, torch.Generator().manual_seed(0), 5)
        assert xs.shape == (5, h, d), name
        assert params.shape == (5, fam.dim_features, d), name
        assert bool(torch.isfinite(xs).all()), name
        assert fam.predict_mean(state).shape == (h, d), name


def test_runner_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ppi_tpu_torch.runners import run_mpc
    args = run_mpc.build_parser().parse_args(
        ["Lbps", "door-v0", "SquaredExponentialKernel", "MonteCarlo"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mpc.main(args)


def test_opt_runner_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from ppi_tpu_torch.runners import run_opt
    args = run_opt.build_parser().parse_args(["Reps", "NoisySphere", "mc"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_opt.main(args)


@pytest.mark.parametrize("runner", ["collect_expert", "train_sac_expert"])
def test_expert_runners_cuda_without_a_card_raise(runner):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib
    mod = importlib.import_module(f"ppi_tpu_torch.runners.{runner}")
    args = mod.build_parser().parse_args([])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)


def test_experts_default_to_the_card():
    import inspect
    from ppi_tpu_torch.envs import (
        door_adroit, door_hand, hammer_adroit, hammer_hand, pen_hand,
        relocate_adroit, relocate_hand)
    for fn in (door_hand.scripted_open, door_adroit.scripted_open,
               pen_hand.scripted_reorient, relocate_hand.scripted_carry,
               relocate_adroit.scripted_carry, hammer_hand.scripted_hammer,
               hammer_adroit.scripted_hammer_adroit):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_palm_ik_has_no_cpu_fallback_for_other_devices():
    from ppi_tpu_torch.envs.hammer_hand import HammerHand
    from ppi_tpu_torch.envs.physics.ik_kernel import palm_ik
    meta = lambda n: torch.zeros(n, device="meta")
    with pytest.raises(TypeError, match="no palm-IK kernel"):
        palm_ik(HammerHand(), meta(4), meta(6), meta(3), meta(4), meta(4),
                3, 0.02, 0.05, meta(3))


def test_kernel_wrapper_has_no_cpu_fallback_for_other_devices():
    """CPU tensors take the plain version; any other device launches the
    kernel or raises -- nothing falls back."""
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.envs.physics.rollout_kernel import make_rollout
    door = Door(fixed_scene=True)
    run = make_rollout(door._model, door.dt, door.substeps, 2, 4,
                       door.scalar_torque, door.scalar_reward, dyn_body=4)
    meta = torch.zeros((3, 6), device="meta")
    with pytest.raises(TypeError, match="no rollout kernel"):
        run(meta, meta, torch.zeros((3, 2, 4), device="meta"))
    from ppi_tpu_torch.ops import m_projection
    from ppi_tpu_torch.ops.cuda_ops import m_projection_cuda
    with pytest.raises(TypeError, match="no moment-match kernel"):
        m_projection_cuda(torch.zeros(3, device="meta"), meta)
    with pytest.raises(TypeError, match="no moment-match kernel"):
        m_projection(torch.zeros(3, device="meta"), meta, use_kernel="always")


def test_rollout_stage_lays_out_the_kernel_operands():
    """``stage`` copies the (N, nq) lanes and (N, H, d_a) actions to the
    kernel's lane-major layout, allocates the (H, N) rewards and (nq, N)
    final state that ``launch`` fills and takes the kernel's eight pointers
    once; the wrapper's ``run.stage`` checks as ``run`` does and has no
    path off the card."""
    from ppi_tpu_torch.envs.door import Door
    from ppi_tpu_torch.envs.physics import rollout_kernel as rk
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((5, 3), generator=gen)
    qd0 = torch.randn((5, 3), generator=gen)
    acts = torch.randn((5, 4, 2), generator=gen)
    consts = torch.ones(2)
    ptrs, outs, ins = rk.stage(q0, qd0, acts, None, consts)
    q_t, qd_t, a_t, dyn, c = ins
    assert torch.equal(q_t, q0.T) and torch.equal(qd_t, qd0.T)
    assert torch.equal(a_t, acts.permute(1, 2, 0))
    assert all(x.is_contiguous() for x in (q_t, qd_t, a_t))
    assert dyn is None and c is consts
    assert [tuple(x.shape) for x in outs] == [(4, 5), (3, 5), (3, 5)]
    assert all(x.dtype == torch.float32 for x in outs)
    assert ptrs == (q_t.data_ptr(), qd_t.data_ptr(), a_t.data_ptr(), None,
                    consts.data_ptr(), *[x.data_ptr() for x in outs])
    door = Door(fixed_scene=True)
    run = rk.make_rollout(door._model, door.dt, door.substeps, 2, 4,
                          door.scalar_torque, door.scalar_reward,
                          dyn_body=4)
    q, qd = torch.zeros((3, door._model.nq)), torch.zeros((3, door._model.nq))
    with pytest.raises(TypeError, match="no rollout kernel for cpu"):
        run.stage(q, qd, torch.zeros((3, 2, 4)))
    meta = torch.zeros((3, door._model.nq), device="meta")
    with pytest.raises(TypeError, match="no rollout kernel for meta"):
        run.stage(meta, meta, torch.zeros((3, 2, 4), device="meta"))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
