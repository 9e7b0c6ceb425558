"""The ball-in-a-cup kernel (``csrc/bic_rollout.cu`` + the body that
``envs/physics/bic_kernel.py`` generates) built as host C against its plain
version, the eager scalar program, on the CPU; its wrapper's routing.

Tolerances (host C against plain; libm's sinf/cosf differ from torch's in
the last bit for some inputs): the coordinates, the particles and the
reward to 1e-5 of 1 + |plain|; the reward statistics, sums of squared
velocities that are differences over dt, to 1e-4; the string's reaction,
a second difference of the particles over dt^2, to 1e-3 N; the success
flags and the NaN lanes exactly. Measured: 1.0e-6 (a joint velocity),
1.9e-5 (the ball's squared speed, lagged coupling) and 5.1e-4 N.

The branch case swings a raised elbow for 60 steps, where some lanes catch
the ball and some hit the arm with it: there the slack string amplifies a
last-bit difference some ten-fold every 10 steps after the first 20, so
it is held to the card check's tolerances (``chip_smoke.py``: 1e-4, 1e-3,
1e-2 N; measured 1.1e-5, 6.4e-4 and 3.4e-3 N), the flags exactly.
"""

import re

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu_torch.build import LAUNCHES
from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
from ppi_tpu_torch.envs.episodic import BallInACup
from ppi_tpu_torch.envs.physics import bic_kernel as bk

Q_START = torch.tensor([0.0, 0.0, 0.0, 1.5707])
TOL, STATS_TOL, REACTION_ATOL = 1e-5, 1e-4, 1e-3
BRANCH_TOLS = (1e-4, 1e-3, 1e-2)
PAD = 5       # sentinel lanes past N in each output buffer
SENTINEL = 7.0


def _actions(n, t, seed, nan_lane=None):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, t, 4), np.float32)
    a[..., 1] = 1.5707
    a[..., :2] += 0.3 * rng.standard_normal((n, t, 2))
    a[..., 2:] = 2.0 * rng.standard_normal((n, t, 2))
    if nan_lane is not None:
        a[nan_lane, 1, 0] = np.nan
    return torch.from_numpy(a)


def _host(sim, actions):
    """The host-C build on ``actions``: (state (N, S), reward, success,
    the sentinels past N untouched)."""
    fn = bk.load_host_bic(bk.generate_bic_header(sim))
    n, t = actions.shape[:2]
    size = sim.layout.size
    act = actions.permute(1, 2, 0).contiguous()
    state = torch.full((size * n + PAD,), SENTINEL)
    score = torch.full((2 * n + PAD,), SENTINEL)
    assert fn(Q_START.data_ptr(), act.data_ptr(), state.data_ptr(),
              score.data_ptr(), n, t, sim.stabilize_steps,
              sim.cooldown_steps) == 0
    untouched = bool((state[size * n:] == SENTINEL).all()
                     and (score[2 * n:] == SENTINEL).all())
    st = state[:size * n].reshape(size, n).t()
    sc = score[:2 * n].reshape(2, n)
    return st, sc[0], sc[1], untouched


def _compare(sim, got, plain, tols=(TOL, STATS_TOL, REACTION_ATOL)):
    tol, stats_tol, reaction_atol = tols
    st, r, ok = got
    pst, pr, pok = plain
    L = sim.layout
    assert torch.equal(torch.isnan(st), torch.isnan(pst))
    a, b = st.double().nan_to_num(0.0), pst.double().nan_to_num(0.0)
    rel = (a - b).abs() / (1 + b.abs())
    assert float(rel[:, :L.FORCE].max()) <= tol
    assert float(rel[:, L.MAX_POT:].max()) <= stats_tol
    assert float((a - b)[:, L.FORCE:L.MAX_POT].abs().max()) <= reaction_atol
    assert torch.equal(torch.isnan(r), torch.isnan(pr))
    rr, pp = r.double().nan_to_num(0.0), pr.double().nan_to_num(0.0)
    assert float(((rr - pp).abs() / (1 + pp.abs())).max()) <= tol
    assert torch.equal(ok, pok)
    assert torch.equal(st[:, L.VIOLATED], pst[:, L.VIOLATED])


@pytest.mark.parametrize("same_step", [True, False])
def test_host_build_matches_plain(same_step):
    """N=37 lanes, 3 + 4 + 2 steps, lane 5 poisoned with a NaN setpoint:
    the host-C build equals the plain version within the tolerances, the
    NaN stays in lane 5 and the lanes past N are not written."""
    sim = BallInCupSim(stabilize_steps=3, cooldown_steps=2,
                       same_step_coupling=same_step)
    acts = _actions(37, 4, 0, nan_lane=5)
    *got, untouched = _host(sim, acts)
    plain = bk.plain_bic_rollout(sim, Q_START, acts)
    _compare(sim, got, plain)
    assert untouched
    bad = torch.isnan(got[0]).any(1)
    assert bad.nonzero().flatten().tolist() == [5]
    assert bool(torch.isnan(got[1][5]))


def test_host_build_takes_the_success_and_violation_branches():
    """64 lanes that hold the shoulder in [0.2, 1.2] and the elbow in
    [2.4, 2.9] rad over 5 + 60 + 5 steps (``chip_smoke.catch_actions``):
    the plain version catches the ball in some and hits the arm with it in
    others, and the host-C build takes the same branches, its latched
    violations freezing the same statistics."""
    sim = BallInCupSim(stabilize_steps=5, cooldown_steps=5)
    rng = np.random.default_rng(39)
    a = np.zeros((64, 60, 4), np.float32)
    a[..., 0] = rng.uniform(0.2, 1.2, (64, 1))
    a[..., 1] = rng.uniform(2.4, 2.9, (64, 1))
    acts = torch.from_numpy(a)
    *got, untouched = _host(sim, acts)
    plain = bk.plain_bic_rollout(sim, Q_START, acts)
    _compare(sim, got, plain, BRANCH_TOLS)
    successes = int(plain[2].sum())
    violated = int((plain[0][:, sim.layout.VIOLATED] != 0).sum())
    assert successes > 0 and violated > 0 and successes + violated < 64
    assert untouched


def test_host_build_of_another_resolution():
    """A 6-particle string (4 Jacobi sweeps: the count scales with the
    resolution squared) has a body of its own: its host-C build against
    its plain version."""
    sim = BallInCupSim(n_particles=6, stabilize_steps=2, cooldown_steps=2)
    acts = _actions(9, 3, 1)
    *got, untouched = _host(sim, acts)
    _compare(sim, got, bk.plain_bic_rollout(sim, Q_START, acts))
    assert untouched and got[0].shape == (9, sim.layout.size)


def test_header_is_deterministic_and_unrolled():
    """The body is generated per sim (its string, sweeps and coupling),
    deterministically; every array it reads or writes is indexed by a
    literal (the generator unrolls every particle loop); the ops of a lane
    step count both passes of the same-step coupling."""
    sim = BallInCupSim()
    text = bk.generate_bic_header(sim)
    assert text == bk.generate_bic_header(BallInCupSim())
    for name in ("bic_reset", "bic_arm", "bic_string", "bic_commit",
                 "bic_score"):
        assert f"void {name}(" in text or f"float {name}(" in text
    assert re.findall(r"\b(?:s|str|arm|q0|qdes|qddes|reaction|score)"
                      r"\[([^\]]+)\]", text)
    assert all(i.isdigit() for i in re.findall(
        r"\b(?:s|str|arm|q0|qdes|qddes|reaction|score)\[([^\]]+)\]", text))
    assert "#define PPI_BIC_S 99" in text
    assert "#define PPI_BIC_SAME_STEP 1" in text
    ops = bk._generate(sim)[1]
    assert bk.ops_per_lane_step(sim) == 2 * (ops["arm"] + ops["string"]) \
        + ops["commit"]
    lagged = BallInCupSim(same_step_coupling=False)
    assert "#define PPI_BIC_SAME_STEP 0" in bk.generate_bic_header(lagged)
    assert bk.ops_per_lane_step(lagged) < bk.ops_per_lane_step(sim)
    fine = bk.generate_bic_header(BallInCupSim(n_particles=24))
    assert "#define PPI_BIC_S 171" in fine and "(24 particles, 60 sweeps)" \
        in fine


def test_wrapper_routes_by_device():
    """CPU tensors take the plain version and launch nothing; another
    device launches the kernel or raises; the env's evaluation is the
    wrapper's (costs 100 - reward)."""
    sim = BallInCupSim(stabilize_steps=2, cooldown_steps=1)
    run = bk.make_bic_rollout(sim)
    acts = _actions(4, 2, 2)
    before = {k: LAUNCHES[k] for k in bk.LAUNCH_KEYS.values()}
    st, r, ok = run(Q_START, acts)
    pst, pr, pok = bk.plain_bic_rollout(sim, Q_START, acts)
    assert torch.equal(st, pst) and torch.equal(r, pr) and torch.equal(ok,
                                                                      pok)
    assert {k: LAUNCHES[k] for k in bk.LAUNCH_KEYS.values()} == before
    meta = torch.zeros((4, 2, 4), device="meta")
    with pytest.raises(TypeError, match="no ball-in-a-cup kernel"):
        run(Q_START.to("meta"), meta)
    env = BallInACup(sim=sim)
    costs, success = env.evaluate(None, acts)
    assert torch.equal(costs, -(pr - 100.0))
    assert success.dtype == torch.bool and torch.equal(success, pok != 0)
