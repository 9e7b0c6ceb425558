"""The rollout kernel's split layout (csrc/rollout_split.cu) on the CPU.

door-v0 plans and steps through the split layout (hammer-v0 has a split
body too, held here, but keeps the lane layout: it was slower on the
card); each group of 32 rollouts is one block, and the lane layout's own
substep and reward (the ``Emitter`` lines of ``env_substep`` and
``env_reward``) are list-scheduled over the block's warps into streams
and phases (``envs/physics/split_layout.py``); a value another stream
reads goes through a shared-memory slot after a barrier. The skeleton
also compiles as host C, each phase run stream by stream and each
stream lane by lane. Held here: the host-C split build against the host-C lane build bit for
bit (rewards, final state, a ragged group, a NaN lane, a second door frame
or board); the schedule's invariants for every body of the runner, from
the generator alone (each op on one stream, each read of another stream's
value after a barrier that follows its store, no slot reused while live);
the two split headers by sha256, and the generator's result read back
from its disk cache; and both envs' plain path and split build against
``ppi_tpu`` on the same numpy inputs.
"""

import functools
import hashlib

import jax
import numpy as np
import pytest
import torch

from test_torch_warp_layout import _bits, _host_run, _lanes, _needs_cc
from torch_env_helpers import (
    Q_TOL, REW_TOL, assert_rollout_close, jax_rollout_fn, port_state,
    wrapper_run)
from torch_helpers import to_np, to_torch
from ppi_tpu.envs.door import Door as JaxDoor
from ppi_tpu.envs.hammer import Hammer as JaxHammer
from ppi_tpu_torch.envs.door import DoorState
from ppi_tpu_torch.envs.hammer import HammerState
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import split_layout as spl
from ppi_tpu_torch.runners.run_mpc import ENVS, KERNEL_ENVS

SPLIT_ENVS = ("door-v0", "hammer-v0")
N, H = 37, 3   # one full group of 32 rollouts and a ragged one

# sha256 of the two split headers as first generated
SPLIT_SHA256 = {
    "door-v0":
        "65697e807e842148f8f0a32f642314766d6bf53e0a2b685f5de19e87198c4b32",
    "hammer-v0":
        "090f98cbb3bdab3b0f0b8124eec9432a796c809e6d38c8feea9b1cb48a9a9c82",
}


def _state(name, seed=0):
    return ENVS[name]().reset(torch.Generator().manual_seed(seed), "cpu")


@functools.cache
def _split(name):
    """(split header, generator report) of ``name``'s body, generated once
    (the search runs at every ``generate_split``)."""
    return rk.generate_split(*rk.body_args(ENVS[name](), _state(name)))


@pytest.fixture(scope="module")
def builds():
    """name -> (lane host-C function, split host-C function)."""
    _needs_cc()
    out = {}
    for name in SPLIT_ENVS:
        args = rk.body_args(ENVS[name](), _state(name))
        out[name] = (rk.load_host_rollout(rk.generate_env_header(*args)),
                     rk.load_host_split_rollout(_split(name)[0]))
    return out


def _assert_same(got, ref):
    """Rewards bit for bit; the final state bit for bit wherever it is a
    number, NaN where the lane build's is: a NaN's sign and payload are
    the host compiler's (it may commute an operation whose operands are
    both NaN), while the card's NaN is canonical (chip_smoke.py and
    tests/test_torch_cuda.py compare every bit there)."""
    np.testing.assert_array_equal(_bits(got[0]), _bits(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        nan = np.isnan(r)
        np.testing.assert_array_equal(np.isnan(g), nan)
        np.testing.assert_array_equal(_bits(g[~nan]), _bits(r[~nan]))


@pytest.mark.parametrize("name", SPLIT_ENVS)
def test_host_c_split_build_equals_lane_build(builds, name):
    """N=37 (a full group and a ragged one), H=3 from the seed-0 state with
    a NaN lane: the split build's rewards and final state are the lane
    build's bit for bit and the plain version's within the rollout
    tolerances; no write past the last rollout; the NaN lane's rewards are
    NaN and every other lane's finite; a second door frame or board
    (``dyn``) changes the rewards and the two builds still agree."""
    env, state = ENVS[name](), _state(name)
    lane, split = builds[name]
    q0, qd0, acts = _lanes(name, state, N, H)
    q0[33, 1] = np.nan   # in the ragged group
    got = _host_run(split, env, state, q0, qd0, acts)
    _assert_same(got, _host_run(lane, env, state, q0, qd0, acts))
    assert np.isnan(got[0][33]).all()
    keep = np.arange(N) != 33
    assert np.isfinite(got[0][keep]).all()
    plain = [to_np(x)[keep] for x in rk.env_plain_rollout(
        env, state, to_torch(q0), to_torch(qd0), to_torch(acts))]
    np.testing.assert_allclose(got[0][keep], plain[0], **REW_TOL)
    np.testing.assert_allclose(got[1][keep], plain[1], **Q_TOL)
    np.testing.assert_allclose(got[2][keep], plain[2], **REW_TOL)

    second = _state(name, seed=2)
    d0, d1 = rk.kernel_operands(env, state)[2], rk.kernel_operands(
        env, second)[2]
    assert not torch.equal(d0, d1)
    got1 = _host_run(split, env, second, q0, qd0, acts)
    _assert_same(got1, _host_run(lane, env, second, q0, qd0, acts))
    assert not np.array_equal(got1[0][keep], got[0][keep])


def _simulate(plan, input_slots, region, last_phase_stores=None):
    """Run ``plan``'s bindings, ops, stores and carries phase by phase,
    stream by stream, over value names, and check: every live op runs once,
    on one stream, after its operands are bound in its function; a slot
    load finds the value it names, stored by another stream only in an
    earlier phase; no stream loads a slot in the phase another stores it;
    a carry register holds the value named; a store is an output's, or
    lies in the program's own slots, ``region``. Returns the slots' final
    values."""
    prog, sched, lay = plan.prog, plan.sched, plan.lay
    index = {name: v for v, name in enumerate(prog.names)}
    runs = {}
    for (p, s), ops in sched.order.items():
        for v in ops:
            assert v not in runs and not prog.literal[v]
            assert (sched.phase[v], sched.stream[v]) == (p, s)
            runs[v] = (p, s)
    assert set(runs) == {v for v in range(len(prog.names))
                         if not prog.literal[v]}
    slot = {at: (name, -1, None) for name, at in input_slots.items()}
    regs = [{} for _ in range(sched.k)]
    stored, loaded = {}, {}
    for p in range(sched.phases):
        for s in range(sched.k):
            scope = set()
            for name, expr in lay.binds[(p, s)]:
                assert name not in scope
                if expr.startswith("sh["):
                    at = int(expr[3:-1]) // spl.LANES
                    held, when, who = slot[at]
                    assert held == name, (name, at, held)
                    assert when < p or who == s, (name, at, when, p)
                    loaded.setdefault((at, p), set()).add(s)
                elif expr.startswith("reg["):
                    assert regs[s].get(int(expr[4:-1])) == name
                elif name in index:
                    assert prog.literal[index[name]]
                    assert expr == prog.exprs[index[name]]
                else:
                    arr, j = prog.inputs[name]
                    assert expr == f"{arr}[{j}]"
                    assert name not in prog.input_slot
                scope.add(name)
            for v in sched.order.get((p, s), ()):
                assert all(prog.names[u] in scope for u in prog.preds[v])
                assert all(x in scope for x in prog.reads[v])
                scope.add(prog.names[v])
            for at, name in lay.stores[(p, s)]:
                assert name in scope or name not in index
                assert ((at, name) in prog.outputs
                        or region[0] <= at < region[1]), (at, name)
                slot[at] = (name, p, s)
                stored.setdefault((at, p), set()).add(s)
            for r, name in lay.carries[(p, s)]:
                assert name in scope
                regs[s][r] = name
    for (at, p), who in stored.items():
        assert len(who) == 1
        assert not loaded.get((at, p), set()) - who, (at, p)
    if last_phase_stores is not None:
        last = sched.phases - 1
        assert [(at, s) for (at, p), who in stored.items() if p == last
                for s in who] == last_phase_stores
    return slot


def _check_body(name, info):
    """``_simulate`` on ``info``'s substep and reward plans: the substep
    leaves each new q and qd in its slot; the reward's only store in its
    last phase is stream 0's of the reward, its slots lie past the
    substep's and it stores no q or qd; the body's slots fit a block's
    shared memory and it emits (every body's does at 4 streams)."""
    nq = ENVS[name]()._model.nq
    ps, pr = info["substep_plan"], info["reward_plan"]
    inputs = {f"{a}_{j}": info[f"slot_{a}"] + j for a in ("q", "qd")
              for j in range(nq)}
    base = 2 * nq + 1
    mid = base + ps.lay.slots
    final = _simulate(ps, {x: at for x, at in inputs.items()
                           if x in ps.prog.input_slot}, (base, mid))
    for at, x in ps.prog.outputs:
        assert final[at][0] == x
    final = _simulate(pr, {x: at for x, at in inputs.items()
                           if x in pr.prog.input_slot},
                      (mid, info["slots"]),
                      last_phase_stores=[(info["slot_r"], 0)])
    assert final[info["slot_r"]][0] == pr.prog.outputs[0][1]
    assert all(final[at][1] == -1 for at in range(2 * nq))
    assert info["slots"] * spl.LANES * 4 <= spl.SHARED_BYTES
    assert "env_sub_0_0" in spl.emit_body(info)[1]


@pytest.mark.parametrize("name", sorted(KERNEL_ENVS))
def test_schedule_invariants(name):
    """Every body of the runner, from the generator alone (no compile; at 4
    streams): ``_check_body``."""
    _check_body(name, rk.generate_split(*rk.body_args(ENVS[name](),
                                                      _state(name)),
                                        streams=4)[1])


@pytest.mark.parametrize("name", SPLIT_ENVS)
def test_the_chosen_plans_keep_the_invariants(name):
    """door-v0's and hammer-v0's plans as the generator chose them:
    ``_check_body``."""
    _check_body(name, _split(name)[1])


def test_a_group_past_the_shared_memory_raises(monkeypatch):
    """Where a group's slots exceed the shared memory a block may use, the
    generator raises instead of emitting a kernel that cannot launch."""
    info = _split("door-v0")[1]
    monkeypatch.setattr(spl, "SHARED_BYTES",
                        info["slots"] * spl.LANES * 4 - 1)
    with pytest.raises(ValueError, match="shared memory"):
        spl.emit_body(info)


@pytest.mark.parametrize("name", SPLIT_ENVS)
def test_split_headers_are_unchanged(name):
    header = _split(name)[0]
    assert "env_sub_0_0" in header and "env_substep" not in header
    assert hashlib.sha256(header.encode()).hexdigest() == SPLIT_SHA256[name]


def test_the_models_choices():
    """door-v0 takes three warps a group and seven phases a substep (the
    solve stays on one warp), the fastest of two, three and four warps on
    the card (PERF.md section 6); hammer-v0 three warps and six phases;
    both keep the reward on one warp, and each takes the number of warps
    whose step the model prices lowest."""
    door, hammer = _split("door-v0")[1], _split("hammer-v0")[1]
    assert (door["streams"], door["substep_phases"],
            door["reward_streams"]) == (3, 7, 1)
    assert (hammer["streams"], hammer["substep_phases"],
            hammer["reward_streams"]) == (3, 6, 1)
    for info in (door, hammer):
        assert min(info["step_cost_by_streams"],
                   key=info["step_cost_by_streams"].get) == info["streams"]


@pytest.mark.parametrize("name", SPLIT_ENVS)
def test_the_split_header_comes_from_the_cache(name, tmp_path, monkeypatch):
    """The main path's split header (``generate_split_header``) is
    ``generate_split``'s text; the first call writes the generator's result
    to the cache, and a second one reads it back without searching."""
    monkeypatch.setattr(rk, "SPLIT_CACHE", tmp_path)
    args = rk.body_args(ENVS[name](), _state(name))
    assert rk.generate_split_header(*args) == _split(name)[0]
    assert len(list(tmp_path.glob("*.json"))) == 1

    def no_search(*a, **k):
        raise AssertionError("searched again")
    monkeypatch.setattr(spl, "plan_body", no_search)
    assert rk.generate_split_header(*args) == _split(name)[0]


@pytest.fixture(scope="module")
def reference():
    """name -> (JAX state, actions (8, 4, d_a), JAX rollout): one JAX
    compile each, from a sampled frame or board."""
    out = {}
    for name, jenv in (("door-v0", JaxDoor()), ("hammer-v0", JaxHammer())):
        js = jenv.reset(jax.random.key(1))
        q = np.asarray(js.physics.qpos)[:4]
        acts = (q + 0.4 * np.random.default_rng(5).standard_normal(
            (8, 4, 4))).astype(np.float32)
        out[name] = (js, acts, jax_rollout_fn(jenv)(js, acts))
    return out


@pytest.mark.parametrize("name", SPLIT_ENVS)
def test_plain_path_and_split_build_match_reference(reference, builds,
                                                    name):
    """door-v0 routes to the split layout, hammer-v0 to the lane layout;
    the wrapper's CPU path (the plain version) and the host-C split build
    both match ``ppi_tpu``'s rollout on the same numpy inputs within the
    rollout tolerances."""
    js, acts, ref = reference[name]
    env = ENVS[name]()
    state = port_state({"door-v0": DoorState,
                        "hammer-v0": HammerState}[name], js)
    routed = "split" if name == "door-v0" else "lane"
    assert rk.kernel_layout(env) == routed
    assert rk.env_rollout(env, state, 4).layout == routed
    assert_rollout_close(wrapper_run(env, state, acts), ref)
    n = acts.shape[0]
    q0 = np.tile(to_np(state.physics.qpos), (n, 1))
    qd0 = np.tile(to_np(state.physics.qvel), (n, 1))
    assert_rollout_close(_host_run(builds[name][1], env, state, q0, qd0,
                                   acts), ref)
