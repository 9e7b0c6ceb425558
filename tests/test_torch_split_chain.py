"""The split layout's chain cut on the CPU (csrc/rollout_split.cu).

fetch-push, hopper, pen-v0, reacher and finger~spin opt in
(``scalar_split_partition = "chain"``): their split body's substep is
partitioned by the body tree as in tests/test_torch_split_subtree.py, and
then the heaviest group that is
a chain of bodies is cut into contiguous segments over the warps that are
left (``split_layout.chain_cuts``): fetch-push's arm (yaw | shoulder and
elbow | wrist) beside the box's slides, hopper's one chain (root slides |
torso and thigh | leg | foot), pen-v0's pen (slides and yaw | pitch)
beside each fingertip's slides, reacher's two links, finger~spin's three
bodies (each finger body, the spinner with the solve). The search tries
every cut with every solve warp, replication cap and ``rhs_late``, and
skips a choice whose lower bound cannot beat the best so far. Held here:
the host-C chain builds of the five against the host-C lane builds bit
for bit (a ragged group, a NaN lane, H=3) and the plain version within
the rollout tolerances; the
plans against the race and slot simulator of
tests/test_torch_split_layout.py; their groups, solve warps, phases,
slots and model costs; the bounded search against the full enumeration;
the cache entries of the two modes; the five routed headers by sha256;
the routing (and hammer-v0's lane route beside it); and the partition's
name checked.
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
from ppi_tpu_torch.envs.physics import split_layout as spl
from ppi_tpu_torch.runners.run_mpc import ENVS

ROUTED = ("fetch-push", "hopper", "pen-v0", "reacher", "finger~spin")
# the trees that are one chain, which the subtree partition refuses
ONE_CHAIN = ("hopper", "reacher")
N, H = 37, 3   # one full group of 32 rollouts and a ragged one

# per env: the chosen groups of bodies, the solve's warp, the replication
# cap, rhs_late, phases a substep, slots a group, the model's step cost,
# the groupings searched, and the most that cost may be as a share of the
# body's cheapest earlier plan (the subtree partition's, or for a tree that
# is one chain, which the subtree partition refuses, the list plan's)
PLANS = {
    "fetch-push": ([[0], [1, 2], [3], [4, 5]], 0, 64, True, 4, 68, 5335.65,
                   7, 0.8),
    "hopper": ([[0, 1], [2, 3], [4], [5]], 0, 64, True, 5, 105, 10524.0,
               26, 0.65),
    "pen-v0": ([[0, 1, 2, 3], [4], [5, 6], [7, 8]], 0, 64, True, 3, 52,
               18628.75, 5, 0.85),
    "finger~spin": ([[0], [1], [2]], 2, 64, False, 3, 33, 2748.3, 2, 0.9),
    "reacher": ([[0], [1]], 1, 64, False, 2, 8, 2041.75, 2, 0.75),
}

# sha256 of the routed chain headers as first generated
CHAIN_SHA256 = {
    "fetch-push":
        "223266de643010a6f0bc97041ce877eea9626a8dc2e4418be07e4e4d3536130a",
    "hopper":
        "d9a306fdc177c4194a8ecf9ea8286450ddfaa05c5082851724a2ee459ba90409",
    "pen-v0":
        "123f5a83da9474cd4aafe7d7606000a8b2fd2250d5beb5ce5d92d826d8ff3462",
    "reacher":
        "4863e7928a4cf9732876c4afa80952bc3d31ca4111ea63a79c05ca9f4f6bef7a",
    "finger~spin":
        "415225dbe74c344e5078128aba83339277eb60a6550dedb38d119c2bd06a5676",
}


def _state(name, seed=0):
    return ENVS[name]().reset(torch.Generator().manual_seed(seed), "cpu")


def _args(name):
    return rk.body_args(ENVS[name](), _state(name))


@pytest.fixture(scope="module")
def chain():
    """name -> (split header, generator report) of its chain-cut body,
    each searched once for the module."""
    return functools.cache(
        lambda name: rk.generate_split(*_args(name), partition="chain"))


@pytest.mark.parametrize("name", ROUTED)
def test_host_c_chain_build_equals_lane_build(chain, name):
    """N=37 (a full group and a ragged one), H=3 from the seed-0 state with
    a NaN lane: the chain-cut build's rewards and final state are the lane
    build's bit for bit (NaN payloads aside, as in
    tests/test_torch_split_layout.py) and the plain version's within the
    rollout tolerances; no write past the last rollout; the NaN lane's
    rewards are NaN and every other lane's finite."""
    _needs_cc()
    env, state = ENVS[name](), _state(name)
    lane = rk.load_host_rollout(rk.generate_env_header(*_args(name)))
    split = rk.load_host_split_rollout(chain(name)[0])
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


@pytest.mark.parametrize("name", ROUTED)
def test_the_chain_plans_keep_the_invariants(chain, name):
    """The chain-cut substep's and the reward's plans pass the race and
    slot simulator (``_check_body``)."""
    _check_body(name, chain(name)[1])


@pytest.mark.parametrize("name", ROUTED)
def test_the_chain_plans(chain, name):
    """Each body's cut, solve warp, replication, phases, slots and model
    cost a step as the generator chose them, below its cheapest earlier
    plan; the report names the grouping first in each choice's key, every
    grouping searched, and the cheapest laid-out choice is the plan
    kept."""
    groups, solve, cap, rhs_late, phases, slots, cost, cuts, share = \
        PLANS[name]
    info = chain(name)[1]
    part = info["partition"]
    assert part["mode"] == "chain"
    assert part["groups"] == groups
    assert (part["solve_warp"], part["replicate_cap"], part["rhs_late"]) \
        == (solve, cap, rhs_late)
    assert (info["streams"], info["substep_phases"], info["slots"]) \
        == (len(groups), phases, slots)
    assert info["step_cost"] == pytest.approx(cost)
    assert part["groupings"] == cuts
    costs = part["cost_by_choice"]
    cut = "|".join(",".join(map(str, g)) for g in groups)
    key = (f"{cut}_solve{solve}_cap{cap}_rhs{int(rhs_late)}")
    assert costs[key] == info["substep_cost"]
    laid = [c for c in costs.values() if not isinstance(c, str)]
    assert min(laid) == info["substep_cost"]
    assert len({k.split("_solve")[0] for k in costs}) == cuts
    if name in ONE_CHAIN:
        earlier = rk.generate_split(*_args(name))[1]
    else:
        earlier = rk.generate_split(*_args(name), partition="subtree")[1]
    assert info["step_cost"] < share * earlier["step_cost"]


@pytest.mark.parametrize("name", ("fetch-push", "hopper"))
def test_the_bounded_search_finds_the_full_enumerations_plan(
        chain, name, monkeypatch):
    """The search that skips a choice whose lower bound cannot beat the
    best so far keeps the plan the full enumeration keeps (the same
    header and choice); every choice both lay out costs the same, every
    bound it skipped on lies at or above the plan's cost, and it skips
    most choices."""
    full_partition = functools.partial(spl.plan_partition, prune=False)
    with monkeypatch.context() as patch:
        patch.setattr(spl, "plan_partition",
                      lambda *a: full_partition(*a))
        full = rk.generate_split(*_args(name), partition="chain")
    header, info = chain(name)
    assert full[0] == header
    bounded, every = info["partition"], full[1]["partition"]
    for key in ("groups", "solve_warp", "replicate_cap", "rhs_late",
                "copies", "phase_weights"):
        assert bounded[key] == every[key], key
    pruned = 0
    for key, cost in bounded["cost_by_choice"].items():
        if isinstance(cost, str) and cost.startswith("pruned: bound "):
            pruned += 1
            assert float(cost.split()[-1]) >= info["substep_cost"]
        elif key in every["cost_by_choice"]:
            assert cost == every["cost_by_choice"][key], key
    assert not any(isinstance(c, str) and c.startswith("pruned")
                   for c in every["cost_by_choice"].values())
    assert pruned > len(bounded["cost_by_choice"]) / 2


def test_the_modes_have_cache_entries_of_their_own(chain, tmp_path,
                                                   monkeypatch):
    """fetch-push's "subtree" and "chain" headers through the generator's
    cache: two entries, two headers, each its mode's search; a second
    call of each reads its own entry back without a search."""
    monkeypatch.setattr(rk, "SPLIT_CACHE", tmp_path)
    args = _args("fetch-push")
    subtree = rk.generate_split_header(*args, partition="subtree")
    chained = rk.generate_split_header(*args, partition="chain")
    assert len(list(tmp_path.glob("*.json"))) == 2
    assert chained == chain("fetch-push")[0] != subtree

    def no_search(*a, **k):
        raise AssertionError("searched again")
    monkeypatch.setattr(spl, "plan_body", no_search)
    assert rk.generate_split_header(*args, partition="subtree") == subtree
    assert rk.generate_split_header(*args, partition="chain") == chained


@pytest.mark.parametrize("name", ROUTED)
def test_chain_headers_are_pinned(chain, name):
    header = chain(name)[0]
    assert "env_sub_0_0" in header and "env_substep" not in header
    assert hashlib.sha256(header.encode()).hexdigest() \
        == CHAIN_SHA256[name]


@pytest.mark.parametrize("name", ROUTED + ("hammer-v0",))
def test_env_routes_to_its_layout(name):
    """Every env of ``ROUTED`` (fetch-push and hopper, then pen-v0 and
    reacher, then finger~spin) routes to the split layout with the chain
    cut, its launches counted under ``rollout_split``; hammer-v0, whose
    split body was slower than its lane body, keeps the lane layout."""
    env = ENVS[name]()
    if name == "hammer-v0":
        assert (rk.kernel_layout(env), rk.split_partition(env)) == (
            "lane", None)
        assert rk.launch_key(env) == "rollout"
        assert rk.env_rollout(env, _state(name), 2).layout == "lane"
        return
    assert (rk.kernel_layout(env), rk.split_partition(env)) == (
        "split", "chain")
    assert rk.launch_key(env) == "rollout_split"
    assert rk.env_rollout(env, _state(name), 2).layout == "split"


def test_an_unknown_partition_raises():
    args = _args("finger~spin")
    with pytest.raises(ValueError, match="partition must be None, "
                       "'subtree' or 'chain', not 'bogus'"):
        rk.generate_split(*args, partition="bogus")
    with pytest.raises(ValueError, match="partition must be"):
        rk.generate_split_header(*args, partition="bogus")


def test_chain_cuts():
    """The heaviest group that is a chain of two bodies or more is cut,
    every cut from one segment to the free warps; a merged group that is
    no chain is never cut; with no free warp the grouping stays."""
    parents = (-1, 0, 1, 2, -1, 4)   # fetch-push's: an arm and a box
    groups = [[0, 1, 2, 3], [4, 5]]
    cuts = spl.chain_cuts(groups, [5, 4, 3, 2, 1, 1], parents)
    assert len(cuts) == 1 + 3 + 3
    assert cuts[0] == groups
    assert [[0], [1, 2], [3], [4, 5]] in cuts
    assert all(g == [4, 5] or max(g) <= 3 for c in cuts for g in c)
    # the box heavier: its two slides are cut, the arm stays whole
    cuts = spl.chain_cuts(groups, [1, 1, 1, 1, 9, 9], parents)
    assert cuts == [groups, [[0, 1, 2, 3], [4], [5]]]
    chain6 = (-1, 0, 1, 2, 3, 4)   # hopper's: one chain
    assert len(spl.chain_cuts([list(range(6))], [1] * 6, chain6)) \
        == 1 + 5 + 10 + 10
    # a merged group that is not a chain (two children of body 0)
    fork = (-1, 0, 0, -1)
    assert spl.chain_cuts([[0, 1, 2], [3]], [1] * 4, fork) \
        == [[[0, 1, 2], [3]]]
    four = [[0], [1], [2], [3]]
    assert spl.chain_cuts(four, [1] * 4, (-1, 0, 0, 0)) == [four]


def test_chain_equals_subtree_with_no_free_warp(chain):
    """relocate-v0's tree gives four groups, so no warp is free: the chain
    mode's one grouping is the subtree partition's, searched in full as
    the subtree partition searches it (no choice skipped on its bound),
    and it keeps the same plan, its header byte for byte."""
    args = _args("relocate-v0")
    header, info = rk.generate_split(*args, partition="chain")
    subtree = rk.generate_split(*args, partition="subtree")
    assert info["partition"]["groupings"] == 1
    assert {key[key.index("solve"):]: cost for key, cost in
            info["partition"]["cost_by_choice"].items()} \
        == subtree[1]["partition"]["cost_by_choice"]
    assert header == subtree[0]


def test_pen_hand_gains_no_warp_for_its_pen_chain(monkeypatch):
    """pen-v0-hand's four groups (the pen's chain, three two-body digits)
    fill the four warps, so the chain mode cuts nothing. Freeing a warp
    for a cut of the pen's chain means two digits sharing one: the model
    prices every such grouping (each pair of digits merged, the chain cut
    at each joint) above the subtree partition, which is why
    ``chain_cuts`` never merges groups to make room."""
    args = _args("pen-v0-hand")
    subtree = rk.generate_split(*args, partition="subtree")[1]
    digits = [[5, 6], [7, 8], [9, 10]]
    merged = []
    for a, b in ((0, 1), (0, 2), (1, 2)):
        rest = [d for i, d in enumerate(digits) if i not in (a, b)]
        for cut in range(1, 5):
            merged.append(sorted([list(range(cut)), list(range(cut, 5)),
                                  digits[a] + digits[b], *rest]))
    monkeypatch.setattr(spl, "chain_cuts", lambda *a: merged)
    info = rk.generate_split(*args, partition="chain")[1]
    assert info["partition"]["groupings"] == len(merged) == 12
    assert info["partition"]["groups"] in merged
    assert info["step_cost"] > subtree["step_cost"]
