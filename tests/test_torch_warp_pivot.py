"""The warp layout's constant head on the CPU (csrc/rollout_warp.cu).

Where the mass matrix's leading pivots are Python floats (a scene whose
first joints are slides of a free body: the pens, the planar walkers), the
scalar program folds the first steps of ``solve_pd_scalar`` in float64:
the pivot's reciprocal, every row entry and product whose operands are
constants, every cell that stays constant. The warp layout's solve takes
those steps from generated tables (``warp_layout._solve_head``,
``PPI_SOLVE_FROM``) and the rest in registers. Held here bit for bit:
the host-C solve against ``solve_pd_scalar`` on the model's constant
cells, and the host-C warp builds of pen-v0-adroit and fetch-pick (the two
bodies this layout now runs with the six of tests/test_torch_warp_layout.py)
against their lane builds.
"""

import hashlib
import re

import numpy as np
import pytest
import torch

from test_torch_warp_layout import (
    N, H, _assert_same_bits, _bits, _host_run, _lanes, _needs_cc, _state)
from torch_env_helpers import Q_TOL, REW_TOL
from torch_helpers import to_np, to_torch
from ppi_tpu_torch.envs.physics import rollout_kernel as rk
from ppi_tpu_torch.envs.physics import scalar_math as sm
from ppi_tpu_torch.envs.physics.engine_soa import (
    SoaModel, assemble_soa, gauss_jordan_step, solve_pd_scalar)
from ppi_tpu_torch.runners.run_mpc import ENVS, KERNEL_ENVS

NEW_WARP_ENVS = ("pen-v0-adroit", "fetch-pick")

# sha256 of the two warp headers as first generated, beside the six of
# tests/test_torch_warp_layout.py
WARP_SHA256 = {
    "pen-v0-adroit":
        "1efaf7e1880eff04fafd35f107bd5e13b10cbe3fd46f7c9b277b94a00d53f6cd",
    "fetch-pick":
        "64ed66938015906e642b61eae111a7933cf6720c5bdbf79e86691d5f38cca2f1",
}


def _warp_header(name):
    return rk.generate_warp_header(*rk.body_args(ENVS[name](), _state(name)))


def _program_mass(name):
    """The lane program's mass matrix for ``name``: ``assemble_soa`` over
    symbols, a Python float wherever the program folds the cell."""
    env = ENVS[name]()
    m = SoaModel(env._model)
    em = sm.Emitter()
    dyn_body = getattr(env, "scalar_dyn_body", None)
    if dyn_body is not None:
        m = m.with_body_offset(dyn_body, tuple(
            em.input(f"dyn_{k}", "") for k in range(3)))
    q, qd, tau = (tuple(em.input(f"{s}_{j}", "") for j in range(m.nq))
                  for s in ("q", "qd", "tau"))
    return assemble_soa(m, q, qd, tau).mass


def _constant(x) -> bool:
    return not isinstance(x, sm.Sym)


def _spd_with_constants(mass, seed):
    """A diagonally dominant SPD f32 matrix: the model's folded cells (as
    f32), small random off-diagonal cells where the program emits, the
    emitted diagonal above its row's sum; and a right-hand side."""
    nq = len(mass)
    rng = np.random.default_rng(seed)
    mat = np.array([[float(mass[i][j]) if _constant(mass[i][j]) else 0.0
                     for j in range(nq)] for i in range(nq)])
    scale = [abs(mat[i, i]) if _constant(mass[i][i]) else 1.0
             for i in range(nq)]
    for i in range(nq):
        for j in range(i + 1, nq):
            if not _constant(mass[i][j]):
                mat[i, j] = mat[j, i] = (rng.uniform(-0.9, 0.9)
                                         * min(scale[i], scale[j]) / nq)
    for i in range(nq):
        if not _constant(mass[i][i]):
            mat[i, i] = np.abs(mat[i]).sum() + rng.uniform(0.05, 2.0)
    return (mat.astype(np.float32),
            rng.standard_normal(nq).astype(np.float32))


@pytest.mark.parametrize("name", ["pen-v0-adroit", "pen-v0", "cheetah"])
def test_constant_head_solve_equals_solve_pd_scalar(name):
    """The skeleton's solve (host C), whose first 3, 3 and 2 steps are the
    constant head, against ``solve_pd_scalar`` as the lane program runs it
    (the model's constant cells as Python floats, the others f32 tensors),
    on four SPD matrices with the model's constant cells: bit for bit."""
    _needs_cc()
    header = _warp_header(name)
    assert re.search(r"#define PPI_SOLVE_FROM [1-9]", header)
    fn = rk.load_host_warp_solve(header)
    mass = _program_mass(name)
    nq = len(mass)
    for seed in range(4):
        mat, rhs = _spd_with_constants(mass, seed)
        aug = np.ascontiguousarray(np.concatenate([mat, rhs[:, None]], 1))
        assert fn(aug.ctypes.data) == 0
        ref = solve_pd_scalar(
            [[mass[i][j] if _constant(mass[i][j])
              else torch.tensor([mat[i, j]]) for j in range(nq)]
             for i in range(nq)], tuple(torch.tensor([v]) for v in rhs))
        ref = np.array([float(x) for x in ref], np.float32)
        np.testing.assert_array_equal(_bits(aug[:, nq]), _bits(ref))
        np.testing.assert_allclose(aug[:, nq], np.linalg.solve(
            mat.astype(np.float64), rhs.astype(np.float64)), rtol=1e-3,
            atol=1e-5)


@pytest.mark.parametrize("name", NEW_WARP_ENVS)
def test_host_c_warp_build_equals_lane_build(name):
    """N=5, H=2 from the seed-0 state: pen-v0-adroit's and fetch-pick's
    warp builds (host C) are their lane builds bit for bit and the plain
    version's within the rollout tolerances; no write past the last
    rollout; a NaN lane poisons only its own rewards; a second goal (the
    reward constants) changes the rewards and the two builds still
    agree."""
    _needs_cc()
    env, state = ENVS[name](), _state(name)
    assert rk.kernel_layout(env) == "warp"
    args = rk.body_args(env, state)
    lane = rk.load_host_rollout(rk.generate_env_header(*args))
    warp = rk.load_host_warp_rollout(rk.generate_warp_header(*args))
    q0, qd0, acts = _lanes(name, state)
    got = _host_run(warp, env, state, q0, qd0, acts)
    _assert_same_bits(got, _host_run(lane, env, state, q0, qd0, acts))
    plain = [to_np(x) for x in rk.env_plain_rollout(
        env, state, to_torch(q0), to_torch(qd0), to_torch(acts))]
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], plain[0], **REW_TOL)
    np.testing.assert_allclose(got[1], plain[1], **Q_TOL)
    np.testing.assert_allclose(got[2], plain[2], **REW_TOL)

    bad = q0.copy()
    bad[2, 1] = np.nan
    rew_bad, _, _ = _host_run(warp, env, state, bad, qd0, acts)
    assert np.isnan(rew_bad[2]).all()
    keep = np.arange(N) != 2
    np.testing.assert_array_equal(_bits(rew_bad[keep]), _bits(got[0][keep]))

    second = _state(name, seed=2)
    assert not torch.equal(rk.kernel_operands(env, second)[0],
                           rk.kernel_operands(env, state)[0])
    got1 = _host_run(warp, env, second, q0, qd0, acts)
    _assert_same_bits(got1, _host_run(lane, env, second, q0, qd0, acts))
    assert not np.array_equal(got1[0], got[0])
    assert got[0].shape == (N, H)


@pytest.mark.parametrize("name", NEW_WARP_ENVS)
def test_new_warp_headers_are_unchanged(name):
    header = _warp_header(name)
    assert "env_assemble" in header and "env_substep" not in header
    assert hashlib.sha256(header.encode()).hexdigest() == WARP_SHA256[name]


def _folded_pivots(mass):
    """How many leading steps of ``solve_pd_scalar`` on ``mass`` (and a
    symbolic right-hand side) have a pivot that Python folds."""
    em = sm.Emitter()
    aug = [list(row) + [em.input(f"rhs_{i}", "")]
           for i, row in enumerate(mass)]
    k = 0
    while k < len(aug) and _constant(aug[k][k]):
        gauss_jordan_step(aug, k)
        k += 1
    return k


@pytest.mark.parametrize("name", sorted(KERNEL_ENVS))
def test_every_body_yields_a_warp_header(name):
    """Every body of the runner, either layout, yields a warp header; its
    solve's constant head is as long as the lane program's run of folded
    pivots (0, and then no head, for a body whose first pivot is
    symbolic)."""
    header = _warp_header(name)
    assert "env_assemble" in header
    head = re.search(r"#define PPI_SOLVE_FROM (\d+)", header)
    folded = _folded_pivots(_program_mass(name))
    assert (int(head.group(1)) if head else 0) == folded
    assert (head is None) == ("ppi_head_ops" not in header)
