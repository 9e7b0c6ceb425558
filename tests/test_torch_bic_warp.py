"""The ball-in-a-cup kernel's warp layout (``csrc/bic_rollout_warp.cu`` +
the body ``bic_kernel.generate_warp_header`` writes) built as host C
against the one-thread layout's host-C build, on the CPU; its header and
the routing between the layouts.

The two layouts compute every value by the same f32 operations on the
same operands, so they agree bit for bit: every value that is not a NaN,
and NaN where the other is NaN (on the host a NaN's sign bit follows the
compiler's choice of operand order, which the card's canonical NaN does
not have; ``chip_smoke.py`` holds the NaN lanes bit for bit there).
"""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu_torch.build import LAUNCHES
from ppi_tpu_torch.envs.ball_in_a_cup import BallInCupSim
from ppi_tpu_torch.envs.physics import bic_kernel as bk

Q_START = torch.tensor([0.0, 0.0, 0.0, 1.5707])
PAD = 5       # sentinel lanes past N in each output buffer
SENTINEL = 7.0
NAN_LANE = 5
# sha256 of the one-thread layout's header as the parent tree generated
# it: the plain version's operations and their order are unchanged
THREAD_HEADER_SHA256 = {
    "canonical": "d2aa502b3f2bdb8e648d91c316c571b1"
                 "bda45dce1ae3c61acb6e4f64c5ab834b",
    "lagged": "9d507e80d770bd44e9e79632498309bf"
              "9f132625dde829b7c4f0d39e85837855",
    "24 particles": "3d947575bf597da82553d9bb35912f84"
                    "266bf568eec9be08d7cf5492cf862bc6",
    "6 particles": "59952d0152243b5c9fc4b9ed42e58005"
                   "f41666d54af089933f7959ffa40ea97f"}
SIMS = {"canonical": {}, "lagged": {"same_step_coupling": False},
        "24 particles": {"n_particles": 24}, "6 particles": {"n_particles": 6}}


def _actions(n, t, seed, nan_lane=None):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, t, 4), np.float32)
    a[..., 1] = 1.5707
    a[..., :2] += 0.3 * rng.standard_normal((n, t, 2))
    a[..., 2:] = 2.0 * rng.standard_normal((n, t, 2))
    if nan_lane is not None:
        a[nan_lane, 1, 0] = np.nan
    return torch.from_numpy(a)


def _host(sim, actions, layout):
    """``layout``'s host-C build on ``actions``: (state (N, S), score (2,
    N), the sentinels past N untouched)."""
    header = (bk.generate_warp_header(sim) if layout == "warp"
              else bk.generate_bic_header(sim))
    fn = bk.load_host_bic(header, layout)
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
    return (state[:size * n].reshape(size, n).t(),
            score[:2 * n].reshape(2, n), untouched)


def _same(a, b):
    """Bit for bit where not NaN, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.parametrize("name", ["canonical", "lagged", "24 particles"])
def test_warp_build_equals_the_thread_build(name):
    """N=37 over 3 + 4 + 2 steps, a NaN setpoint in lane 5: the warp
    layout's states, rewards and success flags are the one-thread
    layout's bit for bit, the NaN poisons its trajectory alone and no
    output past N is written."""
    sim = BallInCupSim(stabilize_steps=3, cooldown_steps=2, **SIMS[name])
    acts = _actions(37, 4, 0, nan_lane=NAN_LANE)
    st, sc, untouched = _host(sim, acts, "warp")
    ref_st, ref_sc, _ = _host(sim, acts, "thread")
    assert _same(st, ref_st) and _same(sc, ref_sc)
    assert untouched
    assert torch.isnan(st).any(1).nonzero().flatten().tolist() == [NAN_LANE]
    assert bool(torch.isnan(sc[0, NAN_LANE]))
    assert not torch.isnan(st[torch.arange(37) != NAN_LANE]).any()


def test_each_layout_counts_its_own_launches():
    """Each layout has a launch counter of its own, so a count shows which
    layout a run launched; the plain version (CPU tensors) adds to
    none."""
    assert sorted(bk.LAUNCH_KEYS) == sorted(bk.SOURCES)
    assert len(set(bk.LAUNCH_KEYS.values())) == len(bk.LAUNCH_KEYS)
    sim = BallInCupSim(stabilize_steps=2, cooldown_steps=1)
    acts = _actions(3, 2, 1)
    before = {k: LAUNCHES[k] for k in bk.LAUNCH_KEYS.values()}
    for layout in bk.SOURCES:
        run = bk.make_bic_rollout(sim, layout)
        assert run.layout == layout
        run(Q_START, acts)
    assert {k: LAUNCHES[k] for k in bk.LAUNCH_KEYS.values()} == before


def test_warp_build_takes_the_thread_builds_branches():
    """``test_torch_bic_kernel``'s branch case (64 lanes, the shoulder in
    [0.2, 1.2] and the elbow in [2.4, 2.9] rad, 5 + 60 + 5 steps), where
    some lanes catch the ball and some hit the arm with it: the warp
    layout's states and flags are the one-thread layout's bit for bit."""
    sim = BallInCupSim(stabilize_steps=5, cooldown_steps=5)
    rng = np.random.default_rng(39)
    a = np.zeros((64, 60, 4), np.float32)
    a[..., 0] = rng.uniform(0.2, 1.2, (64, 1))
    a[..., 1] = rng.uniform(2.4, 2.9, (64, 1))
    acts = torch.from_numpy(a)
    st, sc, untouched = _host(sim, acts, "warp")
    ref_st, ref_sc, _ = _host(sim, acts, "thread")
    assert _same(st, ref_st) and _same(sc, ref_sc) and untouched
    successes = int(sc[1].sum())
    violated = int((st[:, sim.layout.VIOLATED] != 0).sum())
    assert successes > 0 and violated > 0 and successes + violated < 64


def test_warp_header_is_deterministic_and_its_sweep_a_loop():
    """The warp header is generated per sim, deterministically; it holds
    one segment's function and one point's, not the string unrolled, so it
    is a small fraction of the one-thread header and grows with the
    string's resolution by its tables' rows alone; the skeleton runs the
    sweeps as a loop."""
    sim = BallInCupSim()
    text = bk.generate_warp_header(sim)
    assert text == bk.generate_warp_header(BallInCupSim())
    lines = len(text.splitlines())
    assert lines < 0.35 * len(bk.generate_bic_header(sim).splitlines())
    fine = bk.generate_warp_header(BallInCupSim(n_particles=24))
    assert len(fine.splitlines()) == lines + 2 * (24 - 12)
    assert text.count("void bicw_segment(") == 1
    assert "#define PPI_BIC_NP 13" in text and "#define PPI_BIC_SWEEPS 15" \
        in text and "#define PPI_BIC_NP 25" in fine \
        and "#define PPI_BIC_SWEEPS 60" in fine
    assert "#define PPI_BIC_SAME_STEP 0" in bk.generate_warp_header(
        BallInCupSim(same_step_coupling=False))
    source = (pathlib.Path(bk.__file__).parents[2] / "csrc"
              / "bic_rollout_warp.cu").read_text()
    assert "for (int it = 0; it < PPI_BIC_SWEEPS; ++it)" in source
    # sharing the passes' work takes the arm's second pass to a few
    # percent of the first
    arm_sh = int(text.split("#define PPI_BIC_ARM_SH ")[1].split()[0])
    assert 0 < arm_sh < 100


def test_routing_rule():
    """The warp layout is the route wherever the string's points fit a
    warp's 32 lanes (31 particles and the anchor); a longer string takes
    the one-thread layout, and the warp layout refuses it by name."""
    assert bk.route(BallInCupSim()) == "warp"
    assert bk.route(BallInCupSim(n_particles=24)) == "warp"
    assert bk.route(BallInCupSim(n_particles=31)) == "warp"
    long = BallInCupSim(n_particles=32)
    assert bk.route(long) == "thread"
    assert bk.make_bic_rollout(long).layout == "thread"
    assert bk.make_bic_rollout(BallInCupSim()).layout == "warp"
    assert bk.make_bic_rollout(BallInCupSim(), "thread").layout == "thread"
    with pytest.raises(ValueError, match="do not fit the warp layout"):
        bk.make_bic_rollout(long, "warp")
    with pytest.raises(ValueError, match="at most 32 points"):
        bk.generate_warp_header(long)
    with pytest.raises(ValueError, match="unknown ball-in-a-cup layout"):
        bk.make_bic_rollout(BallInCupSim(), "lane")


@pytest.mark.parametrize("name", list(THREAD_HEADER_SHA256))
def test_thread_header_is_unchanged(name):
    """The one-thread header, the plain version's operations in their
    order, is byte for byte what it was before the scalar program was
    cut into per-point and per-segment helpers."""
    text = bk.generate_bic_header(BallInCupSim(**SIMS[name]))
    assert hashlib.sha256(text.encode()).hexdigest() \
        == THREAD_HEADER_SHA256[name]
