"""The subtree partition's search skips a choice that fails to lay out.

``split_layout.plan_partition`` tries every warp for the solve, every
replication cap and both placements of the right-hand side's sums. At cap
256 with the solve on the first tree's warp, the solve's warp copies every
value it would read from the second tree's warp and runs the whole
substep in phase 0; the originals of the copies are left with no reader,
land in the last phase and would read the second tree's root q after its
overwrite, which ``layout`` refuses. Those two choices are skipped and
recorded, so that hammer-v0, fetch-push, finger~spin and pen-v0 (two or
three trees each) get a partitioned plan. Held here: each plan against
the race and slot simulator of tests/test_torch_split_layout.py; its
host-C build against the host-C lane build bit for bit (a ragged group, a
NaN lane, H=3) and the plain version within the rollout tolerances; the
skipped choices in the report; and a search in which no choice lays out
raising by name.
"""

import functools

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

# per env: its groups of bodies, the solve's warp of the plan kept, and
# the root q that the skipped choices would read after its overwrite
REPAIRED = {
    "hammer-v0": ([[0, 1, 2, 3], [4]], 1, "q_4"),
    "fetch-push": ([[0, 1, 2, 3], [4, 5]], 1, "q_4"),
    "finger~spin": ([[0, 1], [2]], 1, "q_2"),
    "pen-v0": ([[0, 1, 2, 3, 4], [5, 6], [7, 8]], 1, "q_5"),
}
# the choices that fail to lay out on each of them
SKIPPED = ("solve0_cap256_rhs0", "solve0_cap256_rhs1")
N, H = 37, 3   # one full group of 32 rollouts and a ragged one


def _state(name, seed=0):
    return ENVS[name]().reset(torch.Generator().manual_seed(seed), "cpu")


@functools.cache
def _split(name):
    """(split header, generator report) of ``name``'s partitioned body."""
    return rk.generate_split(*rk.body_args(ENVS[name](), _state(name)),
                             partition="subtree")


@pytest.mark.parametrize("name", sorted(REPAIRED))
def test_the_partition_plans_and_keeps_the_invariants(name):
    """The partition plans (a ``ValueError`` before the repair): the groups
    of the body tree, one warp each, the solve on the last tree's warp;
    the substep's and the reward's plans pass the race and slot
    simulator; the model prices the partition below the list plan."""
    groups, solve, _ = REPAIRED[name]
    info = _split(name)[1]
    part = info["partition"]
    assert part["groups"] == groups
    assert (info["streams"], part["solve_warp"]) == (len(groups), solve)
    assert info["substep_phases"] >= 2
    _check_body(name, info)
    listed = rk.generate_split(*rk.body_args(ENVS[name](), _state(name)))[1]
    assert info["step_cost"] < listed["step_cost"]


@pytest.mark.parametrize("name", sorted(REPAIRED))
def test_host_c_partition_build_equals_lane_build(name):
    """N=37 (a full group and a ragged one), H=3 from the seed-0 state with
    a NaN lane: the partitioned build's rewards and final state are the
    lane build's bit for bit (NaN payloads aside) and the plain version's
    within the rollout tolerances; no write past the last rollout; the NaN
    lane's rewards are NaN and every other lane's finite."""
    _needs_cc()
    env, state = ENVS[name](), _state(name)
    lane = rk.load_host_rollout(rk.generate_env_header(
        *rk.body_args(env, state)))
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


@pytest.mark.parametrize("name", sorted(REPAIRED))
def test_the_report_marks_the_skipped_choices(name):
    """Every choice tried is in ``cost_by_choice``: the two that fail to
    lay out with the error's text (the root q read after its overwrite)
    in place of a cost, every other with its cost, the plan kept the
    cheapest of those."""
    costs = _split(name)[1]["partition"]["cost_by_choice"]
    groups, _, root_q = REPAIRED[name]
    assert len(costs) == len(groups) * len(spl.REPLICATE_CAPS) * 2
    skipped = {key for key, cost in costs.items() if isinstance(cost, str)}
    assert skipped == set(SKIPPED)
    for key in SKIPPED:
        assert costs[key].startswith(f"{root_q} is read in the phase that "
                                     "overwrites its slot")
    laid = [cost for key, cost in costs.items() if key not in skipped]
    assert min(laid) == _split(name)[1]["substep_cost"]


def test_no_choice_laid_out_raises(monkeypatch):
    """Where ``layout`` refuses every choice, the partition raises a
    ``ValueError`` that names the number of choices and the first error;
    the list schedule, which does not search, still plans the body."""
    args = rk.body_args(ENVS["hammer-v0"](), _state("hammer-v0"))

    def refuse(*a, **k):
        raise ValueError("refused for the test")

    with monkeypatch.context() as patch:
        patch.setattr(spl, "layout", refuse)
        with pytest.raises(ValueError, match=r"no choice of the subtree "
                           r"partition lays out: all 12 choices failed, "
                           r"the first with: refused for the test"):
            rk.generate_split(*args, partition="subtree")
    assert rk.generate_split(*args)[1]["partition"] is None
