"""MPC experiment runner (torch).

The part of ``ppi_tpu/runners/run_mpc.py`` that the ported envs and
priors use, with the same positional layout plus ``--device``:

    python -m ppi_tpu_torch.runners.run_mpc Lbps door-v0 \\
        SquaredExponentialKernel --delta 0.9 --n-iters 2 --anneal 0.5 \\
        --lengthscale 0.08 MonteCarlo --n-samples 64
    python -m ppi_tpu_torch.runners.run_mpc Mppi relocate-v0 \\
        ColouredNoise --beta 2 --alpha 10 --anneal 0.9 --timesteps 140 \\
        --horizon 20 MonteCarlo --n-samples 256
    python -m ppi_tpu_torch.runners.run_mpc Lbps door-v0-hand \\
        SquaredExponentialKernel --delta 0.9 --n-iters 2 --anneal 0.5 \\
        --lengthscale 0.08 MonteCarlo --n-samples 64
    python -m ppi_tpu_torch.runners.run_mpc Essps hammer-v0 RffFeatures \\
        --n-elites 10 --lengthscale 0.15 MonteCarlo --n-samples 64

Envs: pendulum, cartpole, door-v0, door-v0-hand, door-v0-adroit, pen-v0,
pen-v0-hand, pen-v0-adroit, relocate-v0, relocate-v0-hand,
relocate-v0-adroit, hammer-v0, hammer-v0-hand, hammer-v0-adroit, cheetah,
reacher, finger~spin, fetch-push, fetch-pick, hopper, walker2d,
walker~walk, humanoid-standup (the JAX runner's 23); ``--lengthscale
0.08`` is the hand scenes' canonical "4dt". Every prior of the JAX
package's registry runs;
``--n-features`` and ``--order`` size the RBF and RFF bases, and RBF
features span the episode while every other prior spans the horizon.
``--alpha``, ``--epsilon``, ``--n-elites``, ``--delta`` and ``--beta`` go
to the solver and the prior as in the JAX runner; iCem samples with
particle reuse and acts on the MAP sequence. ``--risk-weight`` blends the
CVaR of the per-step costs at ``--risk-quantile`` into each plan's cost
(``envs.base.risk_aggregate``). ``--device cuda`` (the default) needs a
CUDA card and rolls out through the hand-written kernel (the real env step
of every env too: one launch at N=1, H=1); pendulum and cartpole, which
have no kernel in either package, plan through the eager objective on the
card; ``--device cpu`` runs the eager plain version. With ``--dir`` the
run writes
``args.json``, its ``log`` and ``data.npz`` (the JAX runner's keys) under
``<dir>/<algorithm>_<env>_<policy>_<sampling>_<n>_<seed>_<name>``, and a
second run there stops unless ``--force``. ``--checkpoint-every K`` (with
``--dir``) writes the episode's track, then a checkpoint of the agent's
carry (its generator by state) and the env state, every K control steps;
``--resume`` continues from the checkpoint, bit for bit the uninterrupted
episode. ``--optimize-prior`` refits a kernel prior's hyperparameters to
the warm-started plan by marginal likelihood; ``--model-selection`` builds
the prior from a ``model_selection`` artifact (``--ms-fitted-scale`` keeps
the expert's action variance). With ``--dir`` the run also draws the JAX
runner's plots (``result_warmup``, the observation, action, ESS and
temperature sequences, ``smoothness``; ``--no-plots`` skips them);
``--render`` writes a schematic of the episode (``episode.gif``, or
``.avi``/``.mp4`` by ``--video-format``; an mp4 without an ffmpeg backend
is written as avi) and ``--render-3d`` a ray-cast ``episode_3d.gif``, both
from the episode's qpos on the run's device (``render``, ``render3d``). A
failed render is logged and the run goes on, as in the JAX runner.
"""

import argparse
import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import torch

from ppi_tpu_torch import viz
from ppi_tpu_torch.algorithms import ALGORITHMS, make_solver
from ppi_tpu_torch.envs.cheetah import Cheetah
from ppi_tpu_torch.envs.classic import Cartpole, Pendulum
from ppi_tpu_torch.envs.door import Door
from ppi_tpu_torch.envs.door_adroit import DoorAdroit
from ppi_tpu_torch.envs.door_hand import DoorHand
from ppi_tpu_torch.envs.fetch_pick import FetchPickAndPlace
from ppi_tpu_torch.envs.finger import FingerSpin
from ppi_tpu_torch.envs.hammer import Hammer
from ppi_tpu_torch.envs.hammer_adroit import HammerAdroit
from ppi_tpu_torch.envs.hammer_hand import HammerHand
from ppi_tpu_torch.envs.hopper import Hopper
from ppi_tpu_torch.envs.pen import Pen
from ppi_tpu_torch.envs.pen_adroit import PenAdroit
from ppi_tpu_torch.envs.pen_hand import PenHand
from ppi_tpu_torch.envs.push import FetchPush
from ppi_tpu_torch.envs.reacher import Reacher
from ppi_tpu_torch.envs.relocate import Relocate
from ppi_tpu_torch.envs.relocate_adroit import RelocateAdroit
from ppi_tpu_torch.envs.relocate_hand import RelocateHand
from ppi_tpu_torch.envs.standup import HumanoidStandup
from ppi_tpu_torch.envs.walker import Walker, WalkerWalk
from ppi_tpu_torch.model_selection import fitted_prior
from ppi_tpu_torch.mpc import Mpc, fft_smoothness, signal_power
from ppi_tpu_torch.policies import POLICY_NAMES, design_moments, make_policy
from ppi_tpu_torch.samplers import BY_NAME as SAMPLER_NAMES
from ppi_tpu_torch.utils import (
    checked_device, experiment_dir, load_checkpoint, save_checkpoint,
    save_results, setup_logging, write_args)

# the envs with no scalar kernel contract: planned through the eager
# objective on every device
EAGER_ENVS = {"pendulum": Pendulum, "cartpole": Cartpole}
# the envs whose rollouts and real steps run through the rollout kernel
KERNEL_ENVS = {"reacher": Reacher, "door-v0": Door, "door-v0-hand": DoorHand,
               "door-v0-adroit": DoorAdroit, "cheetah": Cheetah,
               "finger~spin": FingerSpin, "hammer-v0": Hammer,
               "hammer-v0-hand": HammerHand,
               "hammer-v0-adroit": HammerAdroit, "hopper": Hopper,
               "pen-v0": Pen, "pen-v0-hand": PenHand,
               "pen-v0-adroit": PenAdroit, "relocate-v0": Relocate,
               "relocate-v0-hand": RelocateHand,
               "relocate-v0-adroit": RelocateAdroit,
               "humanoid-standup": HumanoidStandup, "fetch-push": FetchPush,
               "fetch-pick": FetchPickAndPlace, "walker2d": Walker,
               "walker~walk": WalkerWalk}
ENVS = {**EAGER_ENVS, **KERNEL_ENVS}


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("algorithm", choices=sorted(ALGORITHMS))
    parser.add_argument("env", choices=sorted(ENVS))
    parser.add_argument("policy", choices=POLICY_NAMES)
    parser.add_argument("--timesteps", type=int, default=250)
    parser.add_argument("--horizon", type=int, default=30)
    parser.add_argument("--n-warmstart-iters", type=int, default=50)
    parser.add_argument("--n-iters", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dir", type=str, default=None)
    parser.add_argument("--name", type=str, default="")
    parser.add_argument("--force", action="store_true",
                        help="rerun even if results exist")
    parser.add_argument("--no-plots", action="store_true")
    parser.add_argument("--render", action="store_true",
                        help="save a schematic episode render (physics "
                             "envs)")
    parser.add_argument("--render-3d", action="store_true",
                        help="also save a ray-cast 3-D episode GIF of the "
                             "scene geometry (render3d; any physics env)")
    parser.add_argument("--video-format", choices=["gif", "avi", "mp4"],
                        default="gif",
                        help="episode render container: gif, avi (the "
                             "MJPEG muxer), mp4 (needs imageio-ffmpeg; "
                             "written as avi otherwise)")
    parser.add_argument("--anneal", type=float, default=1.0)
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="every N control steps write the track, then "
                             "a checkpoint of the agent's carry and the env "
                             "state (needs --dir); resume with --resume")
    parser.add_argument("--resume", action="store_true",
                        help="continue an interrupted episode from the "
                             "experiment dir's checkpoint (implies --force "
                             "for the exists-guard)")
    parser.add_argument("--model-selection", type=str, default=None,
                        help="npz from ppi_tpu_torch.model_selection: the "
                             "prior from fitted (mean, covariance_out, "
                             "kernel params) instead of design_moments")
    parser.add_argument("--ms-fitted-scale", action="store_true",
                        help="with --model-selection, keep the expert's "
                             "action variance instead of the actuator-box "
                             "exploration scale")
    parser.add_argument("--optimize-prior", action="store_true",
                        help="after the warm start, refit the kernel "
                             "hyperparameters to the warm-started posterior "
                             "mean by marginal likelihood (kernel families)")
    parser.add_argument("--risk-quantile", type=float, default=0.25,
                        help="CVaR quantile over per-step plan costs "
                             "(active only with --risk-weight > 0)")
    parser.add_argument("--risk-weight", type=float, default=0.0,
                        help="risk-averse planning: blend weight of the "
                             "CVaR of per-step costs (envs.base."
                             "risk_aggregate); 0 = plain -sum(rewards)")
    # algorithm hyperparameters (the JAX runner's defaults)
    parser.add_argument("--n-elites", type=int, default=10)
    parser.add_argument("--alpha", type=float, default=10.0)
    parser.add_argument("--epsilon", type=float, default=2.0)
    parser.add_argument("--delta", type=float, default=0.9)
    # policy hyperparameters
    parser.add_argument("--beta", type=float, default=2.0)
    parser.add_argument("--lengthscale", type=float, default=1.0)
    parser.add_argument("--n-features", type=int, default=10)
    parser.add_argument("--order", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the rollout kernel) or cpu (the eager "
                             "plain version)")
    sub = parser.add_subparsers(title="sampling", dest="sampling",
                                required=True)
    for samp in sorted(SAMPLER_NAMES):
        sp = sub.add_parser(samp)
        sp.add_argument("--n-samples", type=int, default=64)
    return parser


def build(args):
    """(agent, initial policy state) for the parsed arguments: the env,
    prior, solver and agent on ``args.device``."""
    device = checked_device(args.device)
    env = ENVS[args.env]()
    mean, cov_in, cov_out = design_moments(env.action_low, env.action_high,
                                           ratio=1000.0)
    lengthscale, period = args.lengthscale, env.dt
    if args.model_selection is not None:
        mean, cov_in, cov_out, param, kl = fitted_prior(
            args.model_selection, args.policy, env.action_low,
            env.action_high, args.ms_fitted_scale)
        if param.shape[0] > 1:
            lengthscale = float(param[1])
        if param.shape[0] > 2:
            period = float(param[2])
        logging.info("model selection: %s param=%s kl=%.4f", args.policy,
                     param.tolist(), kl)
    use_particles = args.algorithm == "iCem"
    # RBF features span the whole episode; everything else the horizon
    span = args.timesteps if args.policy == "RbfFeatures" else args.horizon
    family, policy = make_policy(
        args.policy, env.dt * torch.arange(span), env.action_dim,
        mean, cov_in, cov_out, lengthscale=lengthscale, period=period,
        n_features=args.n_features, order=args.order,
        sampler="Particles" if use_particles else args.sampling,
        beta=args.beta, lower=env.action_low, upper=env.action_high,
        max_particles=max(1, int(0.33 * args.n_elites)), device=device)
    solver = make_solver(args.algorithm, alpha=args.alpha,
                         epsilon=args.epsilon, delta=args.delta,
                         n_elites=args.n_elites,
                         dimension=family.dim_features)
    if args.n_samples < family.dim_features:
        # fewer samples than weight dimensions: the fitted input covariance
        # is rank-deficient, the PD guard reverts every update (the mean
        # included), and the episode degenerates to the prior mean
        logging.warning(
            "n_samples=%d < dim_features=%d: the moment-matched covariance "
            "cannot be PD, so every posterior update will be reverted. "
            "Increase --n-samples or reduce --n-features/--horizon.",
            args.n_samples, family.dim_features)
    agent = Mpc(env=env, solver=solver, family=family,
                timesteps=args.timesteps, horizon=args.horizon,
                n_samples=args.n_samples, n_iters=args.n_iters,
                anneal=args.anneal, use_map=use_particles, device=device,
                risk_quantile=args.risk_quantile,
                risk_weight=args.risk_weight)
    return agent, policy


def setup(args):
    """(agent, carry, env_state) for the parsed arguments (``build``), the
    carry and the reset state both seeded with ``args.seed``."""
    agent, policy = build(args)
    gen = lambda: torch.Generator(agent.device).manual_seed(args.seed)
    return (agent, agent.init(policy, gen()),
            agent.env.reset(gen(), agent.device))


def render_episode(name, env, env_state, qpos, out):
    """The schematic render of env ``name``'s episode (the JAX runner's
    dispatch); a failure is logged, not raised."""
    from ppi_tpu_torch import render
    fns = {"door-v0": (render.render_door, "frame"),
           "door-v0-hand": (render.render_door_hand, "frame"),
           "hammer-v0-hand": (render.render_hammer_hand, "board"),
           "relocate-v0": (render.render_relocate, "target"),
           "relocate-v0-hand": (render.render_relocate_hand, "target"),
           "fetch-pick": (render.render_relocate, "target"),
           "pen-v0": (render.render_pen, "target_axis"),
           "pen-v0-hand": (render.render_pen_hand, "target_axis")}
    try:
        if name in fns:
            fn, field = fns[name]
            kw = {"target" if field == "target_axis" else field:
                  getattr(env_state, field)}
            out = fn(env, qpos, out, **kw)
        else:
            out = render.render_planar(env, qpos, out)
        logging.info("rendered %s", out)
    except Exception:
        logging.exception("rendering failed")


def render_episode_3d(env, env_state, qpos, out):
    """The ray-cast 3-D GIF of the episode, the env's dynamic body at its
    episode position; a failure is logged, not raised."""
    from ppi_tpu_torch import render3d
    try:
        dyn_pos = None
        if getattr(env, "scalar_dyn_body", None) is not None:
            dyn_pos = env.scalar_dyn_consts(env_state)
            dyn_pos = dyn_pos if tuple(dyn_pos.shape) == (3,) else None
        out = render3d.save_gif_3d(out, env, qpos, dyn_pos=dyn_pos,
                                   style=render3d.SceneStyle(floor=0.0))
        logging.info("rendered %s", out)
    except Exception:
        logging.exception("3-D rendering failed")


def main(args, callback=None, on_checkpoint=None):
    """Run one episode; returns (return, success, track), or None when the
    result directory already holds results; success is None for an env
    without a success test (cheetah). ``callback(t, env_state, row)`` sees
    every control step (``Mpc.run_episode``); ``on_checkpoint(t, carry,
    env_state)`` runs after each checkpoint is written."""
    filepath = None
    if args.dir is not None:
        name = (f"{args.algorithm}_{args.env}_{args.policy}_{args.sampling}_"
                f"{args.n_samples}_{args.seed}_{args.name}")
        filepath = experiment_dir(Path(args.dir), name,
                                  args.force or args.resume)
        if filepath is None:
            print("experiment done!")
            return None
        write_args(args, filepath)
    setup_logging(filepath, args)
    agent, carry, env_state = setup(args)
    env, device = agent.env, agent.device

    ckpt_path = filepath / "episode_checkpoint.npz" if filepath else None
    track_path = filepath / "episode_track.npz" if filepath else None
    start_step = 0
    if args.resume and ckpt_path is not None and ckpt_path.exists():
        (carry, env_state), start_step = load_checkpoint(
            ckpt_path, (carry, env_state))
        # the policy's window is the last control step's
        carry = dataclasses.replace(carry, window=start_step - 1)
        logging.info("resumed from %s at control step %d", ckpt_path,
                     start_step)

    t0 = time.perf_counter()
    if args.n_warmstart_iters > 0 and start_step == 0:
        carry, wtrace = agent.warm_start(carry, env_state,
                                         args.n_warmstart_iters)
        logging.info("Warm start: %.2f +/- %.2f",
                     float(wtrace["mean"][-1]), float(wtrace["std"][-1]))
        if not args.no_plots and filepath is not None:
            viz.plot_algorithm_result(wtrace, filepath / "result_warmup")
    if args.optimize_prior and start_step == 0:
        if not hasattr(agent.family, "optimize_hyper"):
            raise SystemExit("--optimize-prior requires a kernel policy "
                             f"family, got {args.policy!r}")
        old = carry.policy.hyper.tolist()
        t_fit = time.perf_counter()
        carry = dataclasses.replace(carry, policy=agent.family.optimize_hyper(
            carry.policy, carry.policy.mean))
        logging.info("optimize-prior: hyper %s -> %s, fit %.3f s", old,
                     carry.policy.hyper.tolist(),
                     time.perf_counter() - t_fit)

    if args.checkpoint_every and filepath is not None:
        prev = None
        if start_step > 0:
            if not track_path.exists():
                raise SystemExit(
                    f"--resume: checkpoint at step {start_step} but "
                    f"{track_path} is missing")
            with np.load(track_path) as data:
                prev = {k: data[k] for k in data.files}
            n_rows = len(next(iter(prev.values())))
            if n_rows < start_step:
                raise SystemExit(
                    f"--resume: track file has {n_rows} steps but the "
                    f"checkpoint says {start_step} — inconsistent state")
            # a crash between the track write and the checkpoint write
            # leaves extra rows (the checkpoint is the commit point): trim
            # to the checkpointed step and replay the last chunk
            prev = {k: torch.from_numpy(v[:start_step]).to(device)
                    for k, v in prev.items()}

        def on_chunk(t, c, es, tracks):
            # track first, checkpoint second: the checkpoint's step is the
            # commit point, so every crash window resumes consistently
            np.savez(track_path, **{
                k: torch.cat(([prev[k]] if prev else [])
                             + [tr[k] for tr in tracks]).cpu().numpy()
                for k in tracks[0]})
            save_checkpoint(ckpt_path, (c, es), step=t)
            if on_checkpoint is not None:
                on_checkpoint(t, c, es)

        carry, env_state, track = agent.run_episode_resumable(
            carry, env_state, start=start_step, chunk=args.checkpoint_every,
            on_chunk=on_chunk, callback=callback)
        if prev:
            track = ({k: torch.cat([prev[k], track[k]]) for k in track}
                     if track else prev)
    else:
        if start_step:
            raise SystemExit("--resume: the episode was checkpointed; "
                             "resume it with --checkpoint-every")
        carry, env_state, track = agent.run_episode(carry, env_state,
                                                    callback)
    ret = float(track["reward"].sum())
    logging.info("Return: %.2f over %d timesteps", ret, args.timesteps)
    success = None
    if hasattr(env, "success"):
        success = bool(env.success(env_state))
        logging.info("Success: %s", success)
    logging.info("Episode wall time: %.2f s (%s)", time.perf_counter() - t0,
                 device)
    acts = track["action"]
    power = float(signal_power(acts))
    sm, sm_max, sp, freq, act_norm = fft_smoothness(acts, env.dt)
    logging.info("Smoothness: %.3f, Max: %.3f, Power: %.3f", float(sm),
                 float(sm_max), power)
    if not args.no_plots and filepath is not None:
        viz.plot_sequence(track["obs"], filepath / "observation_sequence")
        viz.plot_sequence(acts, filepath / "action_sequence_all")
        viz.plot_sequence(track["ess"], filepath / "ess_history")
        viz.plot_sequence(track["alpha"], filepath / "alpha_history")
        viz.plot_smoothness(sp, freq, act_norm, filepath / "smoothness")
    if args.render and filepath is not None and "qpos" in track:
        render_episode(args.env, env, env_state, track["qpos"],
                       filepath / f"episode.{args.video_format}")
    if args.render_3d and filepath is not None and "qpos" in track:
        render_episode_3d(env, env_state, track["qpos"],
                          filepath / "episode_3d.gif")
    if filepath is not None:
        save_results(filepath, obs=track["obs"], actions=acts,
                     rewards=track["reward"], ess=track["ess"],
                     alphas=track["alpha"], sm=float(sm),
                     sm_max=float(sm_max), power=power,
                     success=np.nan if success is None else float(success),
                     action_signal=act_norm)
    return ret, success, track


if __name__ == "__main__":
    main(build_parser().parse_args())
