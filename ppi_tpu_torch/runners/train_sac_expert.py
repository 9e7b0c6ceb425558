"""SAC expert trainer for the model-selection pipeline.

Port of ``ppi_tpu/runners/train_sac_expert.py`` (the JAX/optax counterpart
of the reference's torch + mushroom_rl SAC expert): train a soft
actor-critic agent on an env (humanoid-standup by default) and log the
trained policy's action stream in ``collect_expert``'s npz layout
(``observations``, ``actions``, ``rewards``), for ``model_selection``.

The same networks, initialisation, hyperparameters and update order:
``MLP`` and ``Actor`` are ``nn.Module``s whose ``Dense`` layers start as
flax's do (a truncated normal of fan-in variance, the lecun-normal
initialiser, and zero biases); the twin critic is one MLP with two heads.
An update draws a batch and two sets of noise, then (``_update``): the TD
target from the target critic and the pre-update temperature, the critic
step, the actor step on the updated critic, the temperature step on the
actor loss's log-probabilities (the pre-update actor's), and the Polyak
average last. Adam is ``torch.optim.Adam`` at optax's defaults (the same
bias-corrected update). The matmuls are ``torch.nn.functional.linear``:
the JAX package leaves them to XLA, outside any Pallas kernel.

``train_chunk`` is a Python loop: ``rollout_steps`` env steps (one
rollout-kernel launch each for a kernel env on the card), pushed to a
device-resident replay ring (``Replay``, updated in place), then
``updates_per_chunk`` updates. Every random draw is taken from an
explicit ``torch.Generator`` apart from where it is used (``Replay.
sample_indices``, the noise of ``sample_action``), so that a test can feed
both packages the same numbers.

    python -m ppi_tpu_torch.runners.train_sac_expert --env humanoid-standup \\
        --steps 100000 --out standup_expert.npz
"""

import argparse
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ppi_tpu_torch.utils import checked_device

# flax's lecun_normal: a normal truncated to +-2 standard deviations,
# scaled by this so that its variance is 1 / fan_in
TRUNCATED_STD = 0.87962566103423978


class MLP(nn.Module):
    """Two ReLU layers of ``hidden`` and a linear head (flax ``MLP``)."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 256,
                 generator=None, device=None):
        super().__init__()
        dims = (in_dim, hidden, hidden, out_dim)
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            w = torch.empty(fan_out, fan_in, device=device)
            std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(
                torch.zeros(fan_out, device=device)))

    def forward(self, x):
        last = len(self.weights) - 1
        for k, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = F.linear(x, w, b)
            if k < last:
                x = F.relu(x)
        return x


class Actor(nn.Module):
    """The tanh-Gaussian policy's (mean, log std), the log std clipped to
    [-5, 2] (flax ``Actor``)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 256,
                 generator=None, device=None):
        super().__init__()
        self.mlp = MLP(obs_dim, 2 * action_dim, hidden, generator, device)

    def forward(self, obs):
        mu, log_std = self.mlp(obs).chunk(2, dim=-1)
        return mu, torch.clamp(log_std, -5.0, 2.0)


def sample_action(actor, obs, eps):
    """tanh-squashed Gaussian sample with its log-probability (SAC's change
    of variables), from the standard normal draws ``eps``."""
    mu, log_std = actor(obs)
    a = torch.tanh(mu + torch.exp(log_std) * eps)
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2.0 * log_std + math.log(2.0 * math.pi))
        - torch.log(1.0 - a ** 2 + 1e-6), dim=-1)
    return a, logp


class Replay:
    """A device-resident ring of transitions, written in place."""

    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device):
        self.obs = torch.zeros((capacity, obs_dim), device=device)
        self.act = torch.zeros((capacity, act_dim), device=device)
        self.rew = torch.zeros((capacity,), device=device)
        self.nobs = torch.zeros((capacity, obs_dim), device=device)
        self.ptr = 0
        self.full = False

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    def push_batch(self, obs, act, rew, nobs):
        """Write ``n`` transitions at the pointer, wrapping."""
        n, cap = obs.shape[0], self.capacity
        idx = (self.ptr + torch.arange(n, device=self.obs.device)) % cap
        self.obs[idx], self.act[idx] = obs, act
        self.rew[idx], self.nobs[idx] = rew, nobs
        self.full = self.full or self.ptr + n >= cap
        self.ptr = (self.ptr + n) % cap

    def sample_indices(self, generator, batch: int):
        """``batch`` uniform indices into the written part of the ring,
        ``[0, max(ptr, 1))`` until it is full."""
        hi = self.capacity if self.full else max(self.ptr, 1)
        return torch.randint(0, hi, (batch,), generator=generator,
                             device=self.obs.device)

    def sample(self, idx):
        return self.obs[idx], self.act[idx], self.rew[idx], self.nobs[idx]


@dataclasses.dataclass
class SacState:
    actor: Actor
    critic: MLP
    critic_target: MLP
    log_alpha: torch.Tensor
    opt_actor: torch.optim.Optimizer
    opt_critic: torch.optim.Optimizer
    opt_alpha: torch.optim.Optimizer
    replay: Replay
    env_state: object
    obs: torch.Tensor
    generator: torch.Generator


class SAC:
    """Compact twin-critic SAC with automatic temperature."""

    def __init__(self, env, gamma=0.99, tau=0.005, lr=3e-4, batch_size=256,
                 rollout_steps=64, updates_per_chunk=64, capacity=200_000,
                 device="cuda"):
        self.env = env
        self.device = torch.device(device)
        self.obs_dim = int(env.observe(env.reset(
            torch.Generator(self.device).manual_seed(0),
            self.device)).shape[0])
        self.act_dim = int(env.action_dim)
        self.gamma, self.tau, self.lr = gamma, tau, lr
        self.batch_size = batch_size
        self.rollout_steps = rollout_steps
        self.updates_per_chunk = updates_per_chunk
        self.capacity = capacity
        self.target_entropy = -float(self.act_dim)
        lo = env.action_low.to(self.device)
        hi = env.action_high.to(self.device)
        self.a_mid, self.a_half = 0.5 * (hi + lo), 0.5 * (hi - lo)

    def scale(self, a):
        return self.a_mid + self.a_half * a

    def _adam(self, params):
        # optax.adam's defaults
        return torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999),
                                eps=1e-8)

    def init(self, generator: torch.Generator) -> SacState:
        """Actor, then critic, drawn from ``generator``, the target a copy
        of the critic, the temperature 1, then the env's reset from the
        same generator, which the training goes on drawing from."""
        dev = self.device
        actor = Actor(self.obs_dim, self.act_dim, generator=generator,
                      device=dev)
        critic = MLP(self.obs_dim + self.act_dim, 2, generator=generator,
                     device=dev)
        target = MLP(self.obs_dim + self.act_dim, 2, device=dev)
        target.load_state_dict(critic.state_dict())
        target.requires_grad_(False)
        log_alpha = torch.zeros((), device=dev, requires_grad=True)
        env_state = self.env.reset(generator, dev)
        return SacState(
            actor=actor, critic=critic, critic_target=target,
            log_alpha=log_alpha, opt_actor=self._adam(actor.parameters()),
            opt_critic=self._adam(critic.parameters()),
            opt_alpha=self._adam([log_alpha]),
            replay=Replay(self.capacity, self.obs_dim, self.act_dim, dev),
            env_state=env_state, obs=self.env.observe(env_state),
            generator=generator)

    # ------------------------------------------------------------------
    def _q(self, critic, obs, act):
        return critic(torch.cat([obs, act], -1))

    @staticmethod
    def _step(opt, params, loss):
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()

    def update(self, state: SacState):
        """One update from ``state.generator``'s draws: the batch indices,
        then the next actions' noise, then the actor's. Returns the critic
        loss."""
        g, dev = state.generator, self.device
        idx = state.replay.sample_indices(g, self.batch_size)
        shape = (self.batch_size, self.act_dim)
        eps_next = torch.randn(shape, generator=g, device=dev)
        eps_actor = torch.randn(shape, generator=g, device=dev)
        return self._update(state, idx, eps_next, eps_actor)

    def _update(self, state: SacState, idx, eps_next, eps_actor):
        """One SAC update on the batch ``idx`` with the given noise, in
        place; returns the critic loss (before its step)."""
        obs, act, rew, nobs = state.replay.sample(idx)
        alpha = torch.exp(state.log_alpha.detach())
        with torch.no_grad():
            na, nlogp = sample_action(state.actor, nobs, eps_next)
            qt = self._q(state.critic_target, nobs, na)
            target = rew + self.gamma * (qt.min(-1).values - alpha * nlogp)

        critic_params = list(state.critic.parameters())
        q = self._q(state.critic, obs, act)
        cl = torch.mean((q - target[:, None]) ** 2)
        self._step(state.opt_critic, critic_params, cl)

        actor_params = list(state.actor.parameters())
        a, logp = sample_action(state.actor, obs, eps_actor)
        q = self._q(state.critic, obs, a)
        al = torch.mean(alpha * logp - q.min(-1).values)
        self._step(state.opt_actor, actor_params, al)

        state.log_alpha.grad = -torch.mean(logp.detach()
                                           + self.target_entropy)
        state.opt_alpha.step()

        with torch.no_grad():
            for t, p in zip(state.critic_target.parameters(), critic_params):
                t.copy_((1 - self.tau) * t + self.tau * p)
        return cl.detach()

    def train_chunk(self, state: SacState):
        """``rollout_steps`` env steps of the current policy into the
        replay, then ``updates_per_chunk`` updates; returns (state, (mean
        critic loss, mean reward of the chunk's steps)), the state
        updated in place."""
        g, es, obs = state.generator, state.env_state, state.obs
        rows = []
        with torch.no_grad():
            for _ in range(self.rollout_steps):
                eps = torch.randn(self.act_dim, generator=g,
                                  device=self.device)
                a, _ = sample_action(state.actor, obs, eps)
                es, rew = self.env.step(es, self.scale(a))
                nobs = self.env.observe(es)
                rows.append((obs, a, rew, nobs))
                obs = nobs
        o, a, r, no = (torch.stack(x) for x in zip(*rows))
        state.replay.push_batch(o, a, r, no)
        state.env_state, state.obs = es, obs
        cls = torch.stack([self.update(state)
                           for _ in range(self.updates_per_chunk)])
        return state, (cls.mean(), r.mean())

    @torch.no_grad()
    def collect(self, state: SacState, generator: torch.Generator,
                steps: int):
        """Roll the trained policy's mean action for ``steps`` from a reset
        drawn from ``generator``; returns (obs, act, rew) as numpy."""
        es = self.env.reset(generator, self.device)
        obs = self.env.observe(es)
        rows = []
        for _ in range(steps):
            mu, _ = state.actor(obs)
            act = self.scale(torch.tanh(mu))
            es, rew = self.env.step(es, act)
            rows.append((obs, act, rew))
            obs = self.env.observe(es)
        return tuple(torch.stack(x).cpu().numpy() for x in zip(*rows))


def main(args):
    """Train, then write the trained policy's ``--collect-steps`` to
    ``--out``; returns (the final ``SacState``, the per-chunk (critic
    loss, mean reward), the collected (obs, act, rew))."""
    from ppi_tpu_torch.runners.run_mpc import ENVS
    device = checked_device(args.device)
    env = ENVS[args.env]()
    sac = SAC(env, rollout_steps=args.rollout_steps,
              batch_size=args.batch_size, device=device)
    state = sac.init(torch.Generator(device).manual_seed(args.seed))
    n_chunks = max(1, args.steps // sac.rollout_steps)
    history = []
    for i in range(n_chunks):
        state, (cl, rbar) = sac.train_chunk(state)
        history.append((float(cl), float(rbar)))
        if i % max(1, n_chunks // 20) == 0:
            print(f"chunk {i}/{n_chunks}: critic loss {history[-1][0]:.4f} "
                  f"mean reward {history[-1][1]:.4f}", flush=True)
    obs, act, rew = sac.collect(
        state, torch.Generator(device).manual_seed(args.seed + 1),
        args.collect_steps)
    np.savez(args.out, observations=obs, actions=act, rewards=rew)
    print(f"wrote {args.out}: return {float(rew.sum()):.2f} over "
          f"{args.collect_steps} steps")
    return state, history, (obs, act, rew)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env", default="humanoid-standup")
    p.add_argument("--steps", type=int, default=100_000)
    p.add_argument("--collect-steps", type=int, default=2000)
    p.add_argument("--rollout-steps", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="standup_expert.npz")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
