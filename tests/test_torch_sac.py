"""The SAC expert trainer (``runners/train_sac_expert.py``) against the
JAX package's flax/optax one, and on its own.

Both packages get the same numbers: the port's networks take the JAX
state's flax parameters (``convert.sac_params_from_flax``), the replay the
same transitions, and each update the batch indices and standard normal
draws that JAX's keys give (the port takes them apart from their use).
Inputs are scaled so that ``tanh`` stays off its saturation, where
``log(1 - a^2 + 1e-6)`` turns a one-ulp difference in ``a`` into 1e-3.
Tolerances: actions and log-probabilities 1e-5; after one update the
critic loss 1e-5 relative, Adam's first moments 1e-7 (``MOMENT_ATOL``),
the parameters 1e-5 absolute where the gradient is not near zero
(``SURE_MOMENT``; measured 2.5e-6, against Adam's first steps of 3e-4) and
within two steps everywhere, ``log_alpha`` 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import to_np
from ppi_tpu.envs.classic import Pendulum as JaxPendulum
from ppi_tpu.runners import train_sac_expert as jsac
from ppi_tpu_torch.convert import sac_params_from_flax
from ppi_tpu_torch.envs.classic import Pendulum
from ppi_tpu_torch.runners import train_sac_expert as tsac

BATCH, CAP = 32, 64
# Adam's first moments (0.1 x the gradient, up to 0.06 here) agree to 3e-8
# (sums in another order)
MOMENT_ATOL = 1e-7
# where |moment| is below this (|g| < 1e-5) a first step's length, lr
# g / (|g| + 1e-8), moves with the gradient's last bits: one of the 65,536
# critic weights read 3.5e-5 apart
SURE_MOMENT = 1e-6


def _transitions(n, obs_dim, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    return (f(n, obs_dim), np.tanh(f(n, 1)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32), f(n, obs_dim))


@pytest.fixture(scope="module")
def pair():
    """(JAX SAC, its state with 40 transitions pushed, the port's SAC,
    its state with the JAX parameters and the same transitions)."""
    sac = jsac.SAC(JaxPendulum(), rollout_steps=16, updates_per_chunk=2,
                   batch_size=BATCH, capacity=CAP)
    js = sac.init(jax.random.key(0))
    data = _transitions(40, sac.obs_dim)
    js = js._replace(replay=js.replay.push_batch(*map(jnp.asarray, data)))
    port = tsac.SAC(Pendulum(), rollout_steps=16, updates_per_chunk=2,
                    batch_size=BATCH, capacity=CAP, device="cpu")
    return sac, js, port, data


def _port_state(port, js, data):
    st = port.init(torch.Generator().manual_seed(0))
    sd = sac_params_from_flax({"actor": js.actor, "critic": js.critic,
                               "critic_target": js.critic_target})
    st.actor.load_state_dict(sd["actor"])
    st.critic.load_state_dict(sd["critic"])
    st.critic_target.load_state_dict(sd["critic_target"])
    st.replay.push_batch(*(torch.from_numpy(x.copy()) for x in data))
    return st


def test_sample_action_matches_reference(pair):
    sac, js, port, data = pair
    st = _port_state(port, js, data)
    obs = data[0][:BATCH]
    key = jax.random.key(3)
    a_ref, logp_ref = jsac.sample_action(js.actor, sac.actor,
                                         jnp.asarray(obs), key)
    eps = np.asarray(jax.random.normal(key, (BATCH, 1)))
    a, logp = tsac.sample_action(st.actor, torch.from_numpy(obs),
                                 torch.from_numpy(eps.copy()))
    np.testing.assert_allclose(to_np(a), np.asarray(a_ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(logp), np.asarray(logp_ref), rtol=0,
                               atol=1e-5)


def test_replay_push_wraps_and_samples_like_reference():
    jr = jsac.Replay.create(8, 3, 1)
    tr = tsac.Replay(8, 3, 1, "cpu")
    for n, seed in ((5, 1), (6, 2)):     # the second push wraps the ring
        data = _transitions(n, 3, seed)
        jr = jr.push_batch(*map(jnp.asarray, data))
        tr.push_batch(*(torch.from_numpy(x.copy()) for x in data))
        assert tr.ptr == int(jr.ptr) and tr.full == bool(jr.full)
        for got, ref in zip((tr.obs, tr.act, tr.rew, tr.nobs),
                            (jr.obs, jr.act, jr.rew, jr.nobs)):
            np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    key = jax.random.key(4)
    ref = jr.sample(key, 16)
    idx = np.asarray(jax.random.randint(key, (16,), 0, 8))
    for got, r in zip(tr.sample(torch.from_numpy(idx).long()), ref):
        np.testing.assert_array_equal(to_np(got), np.asarray(r))


def test_replay_samples_the_written_part_until_full():
    tr = tsac.Replay(100, 2, 1, "cpu")
    g = torch.Generator().manual_seed(0)
    assert int(tr.sample_indices(g, 50).max()) == 0   # [0, max(ptr, 1))
    tr.push_batch(*(torch.from_numpy(x.copy()) for x in _transitions(7, 2)))
    idx = tr.sample_indices(g, 500)
    assert int(idx.min()) == 0 and int(idx.max()) == 6


def test_one_update_matches_reference(pair):
    sac, js, port, data = pair
    st = _port_state(port, js, data)
    key = jax.random.key(5)
    js2, cl = sac._update(js, key)
    k1, k2, k3 = jax.random.split(key, 3)
    hi = CAP if bool(js.replay.full) else max(int(js.replay.ptr), 1)
    idx = np.asarray(jax.random.randint(k1, (BATCH,), 0, hi))
    eps_next = np.asarray(jax.random.normal(k2, (BATCH, 1)))
    eps_actor = np.asarray(jax.random.normal(k3, (BATCH, 1)))
    cl_port = port._update(st, torch.from_numpy(idx.copy()).long(),
                           torch.from_numpy(eps_next.copy()),
                           torch.from_numpy(eps_actor.copy()))
    assert float(cl_port) == pytest.approx(float(cl), rel=1e-5)
    ref = sac_params_from_flax({"actor": js2.actor, "critic": js2.critic,
                                "critic_target": js2.critic_target})
    moments = sac_params_from_flax({"actor": js2.opt_actor[0].mu,
                                    "critic": js2.opt_critic[0].mu})
    before = sac_params_from_flax({"actor": js.actor})["actor"]
    for name, module, opt in (("actor", st.actor, st.opt_actor),
                              ("critic", st.critic, st.opt_critic),
                              ("critic_target", st.critic_target, None)):
        for k, p in module.named_parameters():
            got, want = to_np(p), ref[name][k].numpy()
            if opt is None:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                           err_msg=k)
                continue
            # Adam's first moment, 0.1 x the gradient
            mu = moments[name][k].numpy()
            np.testing.assert_allclose(to_np(opt.state[p]["exp_avg"]), mu,
                                       rtol=0, atol=MOMENT_ATOL, err_msg=k)
            # the first step is lr g / (|g| + 1e-8): determined where the
            # gradient is not near 0, and never longer than lr
            sure = np.abs(mu) >= SURE_MOMENT
            np.testing.assert_allclose(got[sure], want[sure], rtol=0,
                                       atol=1e-5, err_msg=k)
            assert np.abs(got - want).max() <= 2 * port.lr
    moved = max(float((st.actor.state_dict()[k] - before[k]).abs().max())
                for k in before)
    assert moved > 1e-4
    assert float(st.log_alpha.detach()) == pytest.approx(float(js2.log_alpha),
                                                abs=1e-8)


def test_init_has_flax_fan_in_variance():
    g = torch.Generator().manual_seed(0)
    mlp = tsac.MLP(400, 300, hidden=512, generator=g)
    for w, b, fan_in in zip(mlp.weights, mlp.biases, (400, 512, 512)):
        var = float(w.detach().double().var())
        assert var == pytest.approx(1.0 / fan_in, rel=0.02)
        bound = 2.0 * np.sqrt(1.0 / fan_in) / tsac.TRUNCATED_STD
        assert float(w.detach().abs().max()) <= bound
        assert bool((b == 0).all())
    # the JAX init's spread, for comparison
    params = jsac.MLP(300, hidden=512).init(jax.random.key(0),
                                            jnp.zeros(400))
    k = np.asarray(params["params"]["Dense_0"]["kernel"])
    assert float(k.var()) == pytest.approx(1.0 / 400, rel=0.02)


def test_train_chunk_runs_stays_finite_and_moves_the_parameters():
    sac = tsac.SAC(Pendulum(), rollout_steps=32, updates_per_chunk=8,
                   batch_size=64, capacity=2048, device="cpu")
    st = sac.init(torch.Generator().manual_seed(0))
    start = {k: v.clone() for k, v in st.actor.state_dict().items()}
    for _ in range(4):
        st, (cl, rbar) = sac.train_chunk(st)
    assert np.isfinite(float(cl)) and np.isfinite(float(rbar))
    assert st.replay.ptr == 128
    assert any(not torch.allclose(v, st.actor.state_dict()[k])
               for k, v in start.items())


def test_collect_stays_in_the_box():
    env = Pendulum()
    sac = tsac.SAC(env, rollout_steps=16, updates_per_chunk=2, batch_size=32,
                   capacity=512, device="cpu")
    st = sac.init(torch.Generator().manual_seed(0))
    st, _ = sac.train_chunk(st)
    obs, act, rew = sac.collect(st, torch.Generator().manual_seed(1), 50)
    assert obs.shape[0] == act.shape[0] == rew.shape[0] == 50
    assert act.shape[1] == env.action_dim
    assert (act >= to_np(env.action_low) - 1e-5).all()
    assert (act <= to_np(env.action_high) + 1e-5).all()


def test_learns_on_pendulum():
    """The JAX package's gate (tests/test_sac.py): after 40 chunks the
    mean reward of the last five beats the first five's."""
    sac = tsac.SAC(Pendulum(), rollout_steps=64, updates_per_chunk=32,
                   batch_size=128, capacity=20_000, device="cpu")
    st = sac.init(torch.Generator().manual_seed(2))
    rewards = []
    for _ in range(40):
        st, (_, rbar) = sac.train_chunk(st)
        rewards.append(float(rbar))
    assert np.mean(rewards[-5:]) > np.mean(rewards[:5]), rewards


def test_main_writes_the_expert_layout(tmp_path):
    out = tmp_path / "sac.npz"
    args = tsac.build_parser().parse_args(
        ["--env", "pendulum", "--steps", "32", "--rollout-steps", "16",
         "--batch-size", "8", "--collect-steps", "10", "--device", "cpu",
         "--out", str(out)])
    _, history, _ = tsac.main(args)
    data = np.load(out)
    assert sorted(data.files) == ["actions", "observations", "rewards"]
    assert data["actions"].shape == (10, 1) and len(history) == 2
    assert data["actions"].dtype == np.float32
