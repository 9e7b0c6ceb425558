"""The split layout's subtree partition on the CPU (csrc/rollout_split.cu).

relocate-v0, cheetah, walker2d, walker~walk, humanoid-standup and
pen-v0-hand opt in (``scalar_split_partition = "subtree"``): their split
body's substep is partitioned by the model's body tree
(``split_layout.plan_partition``) instead of list-scheduled. Each tree's
root chain and each subtree hanging off it runs on a warp of its own
(cheetah, walker2d and walker~walk: the torso's chain and each leg;
humanoid-standup: the torso's chain, the leg and the arm; relocate-v0:
the arm's chain, each finger and the ball's chain; pen-v0-hand: the pen's
chain and each two-body digit), from the owner tags the scalar program
records while it emits (``scalar_math.owner``), and only the terms of the
shared sums, the frames and the accelerations cross between warps. Held
here: the host-C partitioned builds against the host-C lane builds bit for
bit (a ragged group, a NaN lane, H=3); the plans against the race and slot
simulator of tests/test_torch_split_layout.py; the groups, phases and the
model's costs; the owner tags (every line of the emitted program is the
untagged program's, the plain path unchanged); the six headers by
sha256 and the main path's header read back from the generator's cache; a
chain-shaped tree (hopper's) refused by name; the routing of walker~walk
(walker2d's substep under another reward, planned as walker2d's) and
pen-v0-hand.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from test_torch_split_layout import _assert_same, _check_body
from test_torch_warp_layout import _host_run, _lanes, _needs_cc
from torch_helpers import to_np, to_torch
from torch_env_helpers import Q_TOL, REW_TOL
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics import split_layout as spl
from ppi_tpu_torch.envs.physics.engine_soa import SoaModel, substep_soa
from ppi_tpu_torch.runners.run_mpc import ENVS

SUBTREE_ENVS = ("relocate-v0", "cheetah", "walker2d", "walker~walk",
                "humanoid-standup", "pen-v0-hand")
N, H = 37, 3   # one full group of 32 rollouts and a ragged one

# sha256 of the partitioned split headers as first generated
SUBTREE_SHA256 = {
    "relocate-v0":
        "6324a75871ade63898fdf6acdca1f9ecd8c41af299839da2d743b765ef423fc9",
    "cheetah":
        "fec86c4e88446189e61c9d70fad7848287723743bad146799977bcd6b5893726",
    "walker2d":
        "6c71fe7b681fa73eae5e058639aee00fe4e51cace10c567a7f00357514dd5c8d",
    "humanoid-standup":
        "c64cf3024d4dcc26818b5db4e962bfd9aea138edc6ad386b75400d44a4339ca3",
    "walker~walk":
        "9a3a99956e54c90904de088044e76ac79040d4a44cf51916c86a83b30acadfb1",
    "pen-v0-hand":
        "7a83ef598b86349828ca8dc6106c3634db6887ef833fa927cafdf1dd6682cdee",
}


def _state(name, seed=0):
    return ENVS[name]().reset(torch.Generator().manual_seed(seed), "cpu")


@functools.cache
def _split(name):
    """(split header, generator report) of ``name``'s partitioned body,
    generated once (the search runs at every ``generate_split``)."""
    env = ENVS[name]()
    return rk.generate_split(*rk.body_args(env, _state(name)),
                             partition=rk.split_partition(env))


@pytest.mark.parametrize("name", SUBTREE_ENVS)
def test_host_c_partition_build_equals_lane_build(name):
    """N=37 (a full group and a ragged one), H=3 from the seed-0 state with
    a NaN lane: the partitioned build's rewards and final state are the
    lane build's bit for bit (NaN payloads aside, as in
    tests/test_torch_split_layout.py) and the plain version's within the
    rollout tolerances; no write past the last rollout; the NaN lane's
    rewards are NaN and every other lane's finite."""
    _needs_cc()
    env, state = ENVS[name](), _state(name)
    args = rk.body_args(env, state)
    lane = rk.load_host_rollout(rk.generate_env_header(*args))
    split = rk.load_host_split_rollout(_split(name)[0])
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


@pytest.mark.parametrize("name", SUBTREE_ENVS)
def test_the_partition_keeps_the_invariants(name):
    """The partitioned substep's and the reward's plans pass the race and
    slot simulator (``_check_body``): every op once on one warp after its
    operands, every value of another warp loaded after the barrier that
    follows its store, no slot reused while live."""
    _check_body(name, _split(name)[1])


# per partitioned env: its groups of bodies, warps, phases a substep, the
# warp that runs the solve, and the most its model step may cost as a
# share of its list plan's
PARTITIONS = {
    "cheetah": ([[0, 1, 2], [3, 4, 5], [6, 7, 8]], 3, 3, 0, 0.6),
    "relocate-v0": ([[0, 1, 2, 3], [4], [5], [6, 7, 8]], 4, 4, 3, 0.6),
    "walker2d": ([[0, 1, 2], [3, 4, 5], [6, 7, 8]], 3, 3, 0, 0.6),
    "walker~walk": ([[0, 1, 2], [3, 4, 5], [6, 7, 8]], 3, 3, 0, 0.6),
    "humanoid-standup": ([[0, 1, 2], [3, 4, 5], [6, 7]], 3, 3, 0, 0.6),
    "pen-v0-hand": ([[0, 1, 2, 3, 4], [5, 6], [7, 8], [9, 10]], 4, 4, 1,
                    0.75),
}


def test_the_partitions():
    """cheetah, walker2d and walker~walk: the torso's chain (with the
    solve) and each leg, three phases a substep; humanoid-standup: the
    torso's chain (with the solve), the leg and the arm, three phases;
    relocate-v0: the arm's chain, each finger, and the ball's chain with
    the solve, four phases; pen-v0-hand: the pen's chain, and each
    two-body digit (the solve on the first digit's warp), four phases.
    Each exchanges a few hundred values at most a substep, uses fewer slots
    a group than its list plan and costs the model about half the list
    plan's step (humanoid-standup's the most of the bodies with two legs
    or fingers, 0.56: its arm's warp is the lightest; pen-v0-hand 0.72:
    its pen's chain is most of its first two phases); every phase's weight
    is reported for every warp, and the last phase (the solve's right-hand
    side and the integration) runs on the solve's warp alone."""
    assert sorted(PARTITIONS) == sorted(SUBTREE_ENVS)
    for name, (groups, streams, phases, solve, _) in PARTITIONS.items():
        info = _split(name)[1]
        part = info["partition"]
        assert part["groups"] == groups, name
        assert (info["streams"], info["substep_phases"],
                part["solve_warp"]) == (streams, phases, solve), name
        weights = part["phase_weights"]
        assert len(weights) == phases
        assert all(len(row) == streams for row in weights)
        assert [w > 0 for w in weights[-1]] == [
            s == solve for s in range(streams)], name
    for name in SUBTREE_ENVS:
        info = _split(name)[1]
        env = ENVS[name]()
        listed = rk.generate_split(*rk.body_args(env, _state(name)))[1]
        assert info["partition"]["exchanged"] <= 200
        assert info["slots"] < listed["slots"]
        assert info["step_cost"] < PARTITIONS[name][4] * listed["step_cost"]
        assert info["partition"]["cost_by_choice"]
        assert min(info["partition"]["cost_by_choice"].values()) \
            == info["substep_cost"]


def test_subtree_groups_and_merge():
    """A tree's root chain runs to its first fork; each subtree below a
    fork and each chain-shaped tree is one group; past four groups the two
    lightest merge."""
    assert spl.subtree_groups((-1, 0, 1, 2, 3, 3, -1, 6, 7)) == [
        [0, 1, 2, 3], [4], [5], [6, 7, 8]]
    assert spl.subtree_groups((-1, 0, 1, 2, -1, 4)) == [[0, 1, 2, 3],
                                                        [4, 5]]
    parents = ENVS["door-v0-adroit"]()._soa.parents
    groups = spl.subtree_groups(parents)
    assert len(groups) == 7
    merged = spl._merge(groups, [1] * len(parents))
    assert len(merged) == spl.MAX_STREAMS
    assert sorted(b for g in merged for b in g) == list(range(len(parents)))


def test_the_partition_refuses_a_chain():
    """hopper's tree is one chain (slides, pitch, thigh, leg, foot): one
    group, nothing to put beside it, so the partition raises a
    ``ValueError`` that names the group count and the missing fork before
    any search, and the list schedule still plans the body."""
    env = ENVS["hopper"]()
    args = rk.body_args(env, _state("hopper"))
    assert len(spl.subtree_groups(env._soa.parents)) == 1
    with pytest.raises(ValueError, match=r"needs a fork.*gives 1 group"):
        rk.generate_split(*args, partition="subtree")
    assert rk.generate_split(*args)[1]["partition"] is None


def test_walker_walk_and_pen_hand_route_to_the_partition():
    """walker~walk and pen-v0-hand route to the partitioned split layout,
    as walker2d and humanoid-standup do (each was faster there than on
    the lane layout on the card, PERF.md section 6); walker~walk
    subclasses walker2d, so its substep's plan is walker2d's: the same
    groups and the same weights on every warp in every phase. pen-v0-adroit
    subclasses pen-v0-hand and keeps the warp layout, its split body
    list-scheduled."""
    for name in ("walker~walk", "pen-v0-hand", "walker2d",
                 "humanoid-standup"):
        env = ENVS[name]()
        assert (rk.kernel_layout(env), rk.split_partition(env)) == (
            "split", "subtree"), name
        assert rk.launch_key(env) == "rollout_split"
    walk, walker = (_split(name)[1]["partition"]
                    for name in ("walker~walk", "walker2d"))
    for key in ("groups", "phase_weights", "solve_warp", "replicate_cap",
                "rhs_late", "copies"):
        assert walk[key] == walker[key], key
    adroit = ENVS["pen-v0-adroit"]()
    assert (rk.kernel_layout(adroit), rk.split_partition(adroit)) == (
        "warp", None)


# the most of a substep's live ops that may go untagged: the solve and
# the integration, which grow with the cube of the DoF (pen-v0-hand's 11)
UNTAGGED_SHARE = {"pen-v0-hand": 0.2}


@pytest.mark.parametrize("name", SUBTREE_ENVS)
def test_owner_tags(name):
    """The substep's owner tags name emitted lines (the tags change no
    line: every lane, warp and split header stays pinned in the other
    files); the per-body, per-sphere, per-pair and sum tags cover all the
    live ops but the solve and the integration, the untagged ops the tail
    of the program; over torch tensors ``owner`` changes nothing."""
    env = ENVS[name]()
    m = SoaModel(env._model)
    em = sm.Emitter()
    q, qd, tau = (tuple(em.input(f"{s}_{j}", f"{s}[{j}]")
                        for j in range(m.nq)) for s in ("q", "qd", "tau"))
    q2, qd2 = substep_soa(m, q, qd, tau, env.dt / env.substeps)
    names = {ln.split(" = ")[0].split()[-1] for ln in em.lines}
    assert set(em.owners) <= names
    assert {tag[0] for tag in em.owners.values()} == {
        "body", "sphere", "pair", "mass", "sum"}
    prog = spl.parse(em, list(enumerate(q2 + qd2)),
                     {"q": 0, "qd": m.nq})
    live = [x for x, lit in zip(prog.names, prog.literal) if not lit]
    assert sum(x not in em.owners for x in live) \
        < UNTAGGED_SHARE.get(name, 0.15) * len(live)
    tagged = [x in em.owners for x in live]
    assert tagged == sorted(tagged, reverse=True)
    gen = torch.Generator().manual_seed(0)
    qt, qdt, taut = (tuple(torch.randn(4, generator=gen)
                           for _ in range(m.nq)) for _ in range(3))
    with sm.owner(("body", 0)):
        a = substep_soa(m, qt, qdt, taut, env.dt / env.substeps)
    b = substep_soa(m, qt, qdt, taut, env.dt / env.substeps)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", SUBTREE_ENVS)
def test_partition_headers_are_pinned(name):
    header = _split(name)[0]
    assert "env_sub_0_0" in header and "env_substep" not in header
    assert hashlib.sha256(header.encode()).hexdigest() \
        == SUBTREE_SHA256[name]


@pytest.mark.parametrize("name", SUBTREE_ENVS)
def test_the_partition_header_comes_from_the_cache(name, tmp_path,
                                                   monkeypatch):
    """The main path's split header for a partitioned env is the
    partition's, written to the generator's cache at its first generation
    and read back without a search; the list-scheduled header is another
    entry of the cache."""
    monkeypatch.setattr(rk, "SPLIT_CACHE", tmp_path)
    env = ENVS[name]()
    args = rk.body_args(env, _state(name))
    assert rk.generate_split_header(*args, partition="subtree") \
        == _split(name)[0]
    assert len(list(tmp_path.glob("*.json"))) == 1

    def no_search(*a, **k):
        raise AssertionError("searched again")
    monkeypatch.setattr(spl, "plan_body", no_search)
    assert rk.generate_split_header(*args, partition="subtree") \
        == _split(name)[0]
    with pytest.raises(AssertionError, match="searched again"):
        rk.generate_split_header(*args)
