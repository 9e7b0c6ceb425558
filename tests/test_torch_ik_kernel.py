"""The palm-IK kernel (``csrc/ik_palm.cu`` + ``envs/physics/ik_kernel.py``).

On the CPU: the skeleton and each of the five generated bodies, built as
host C, against the plain version (``plain_palm_ik``, autograd through
``_sites_soa``) at 3 and 50 iterations; the generated gradient at a point
against ``torch.autograd``'s; a digit outside the box clipped although its
gradient is zero; and a NaN target coming back as NaN in every entry (the
arm at the first step, the digits through the non-finite FK at the
second), in both. The card cases (marked ``cuda``) skip
here; with a card and without JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_ik_kernel.py

Tolerances: the host-C build and the plain version run the same f32
program but take the gradient by two routes (the geometric Jacobian
against autograd's chain rule), measured equal to 0 to 5e-7 after 50
iterations; held to 1e-5. The gradient to 1e-5 of 1 + |g|.
"""

import shutil

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (sets torch threads)
from ppi_tpu_torch.build import LAUNCHES
from ppi_tpu_torch.envs.door_adroit import DoorAdroit
from ppi_tpu_torch.envs.door_hand import DoorHand
from ppi_tpu_torch.envs.hammer_adroit import HammerAdroit
from ppi_tpu_torch.envs.hammer_hand import HammerHand
from ppi_tpu_torch.envs.physics import ik_kernel as ik
from ppi_tpu_torch.envs.relocate_adroit import RelocateAdroit

X_TOL = 1e-5
GRAD_TOL = 1e-5

# env, IK variables, level penalty (the expert's), lr, the target's offset
# from the palm at reset and the digit pushed out of its box
BODIES = {
    "door-v0-hand": (DoorHand, 10, None, 0.03, (0.05, -0.04, 0.075), 8),
    "door-v0-adroit": (DoorAdroit, 21, None, 0.03, (0.05, -0.04, 0.075), 20),
    "hammer-v0-hand": (HammerHand, 4, 0.05, 0.02, (0.08, 0.0, 0.12), None),
    "hammer-v0-adroit": (HammerAdroit, 4, 0.005, 0.02, (0.08, 0.0, 0.12),
                         None),
    "relocate-v0-adroit": (RelocateAdroit, 4, 0.05, 0.05, (0.0, 0.0, 0.15),
                           None),
}


def _problem(name, seed=0):
    """(env, x0, q_rest, target, lo, hi, dyn, level weight, lr): the
    reset's posture, nudged by a seeded normal, toward a point off the
    palm; a door digit starts past its upper limit."""
    cls, n, w, lr, offset, digit = BODIES[name]
    env = cls()
    s = env.reset(torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    q = s.physics.qpos.clone()
    q[:4] += torch.from_numpy(0.1 * rng.standard_normal(4).astype(np.float32))
    dyn = getattr(s, "frame", getattr(s, "board", None))
    pts = env._sites_soa(q, dyn)
    target = pts[env._palm_geom] + torch.tensor(offset)
    lo, hi = env.action_low[:n], env.action_high[:n]
    x0 = q[:n].clone()
    if digit is not None:
        x0[digit] = hi[digit] + 0.5
    return env, x0, q[n:].clone(), target, lo, hi, dyn, w, lr


def _host(env, x0, q_rest, target, lo, hi, dyn, w, lr, iters):
    fn = ik.load_host_ik(ik.env_header(env, x0.shape[0], w is not None))
    q_fixed = torch.cat([x0, q_rest])
    params = torch.tensor([lr, 0.0 if w is None else w])
    out = torch.empty_like(x0)
    fn(x0.data_ptr(), q_fixed.data_ptr(), target.data_ptr(),
       None if dyn is None else dyn.data_ptr(), lo.data_ptr(), hi.data_ptr(),
       params.data_ptr(), out.data_ptr(), iters)
    return out


def _needs_cc():
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler")


@pytest.mark.parametrize("name", list(BODIES))
def test_host_build_matches_plain(name):
    """3 and 50 iterations of the host-C build against the plain version
    (the plain 50 continue from its 3), and the IK moves the palm."""
    _needs_cc()
    env, x0, q_rest, target, lo, hi, dyn, w, lr = _problem(name)
    plain3 = ik.plain_palm_ik(env, x0, q_rest, target, lo, hi, 3, lr, w, dyn)
    plain50 = ik.plain_palm_ik(env, plain3, q_rest, target, lo, hi, 47, lr,
                               w, dyn)
    for iters, plain in ((3, plain3), (50, plain50)):
        got = _host(env, x0, q_rest, target, lo, hi, dyn, w, lr, iters)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=X_TOL)
    palm = lambda x: env._sites_soa(torch.cat([x, q_rest]), dyn)[
        env._palm_geom]
    assert float(torch.linalg.norm(palm(plain50) - target)) < 0.8 * float(
        torch.linalg.norm(palm(torch.clamp(x0, lo, hi)) - target))


@pytest.mark.parametrize("name", list(BODIES))
def test_generated_gradient_matches_autograd(name):
    _needs_cc()
    env, x0, q_rest, target, lo, hi, dyn, w, lr = _problem(name, seed=3)
    n = x0.shape[0]
    fn = ik.load_host_grad(ik.env_header(env, n, w is not None))
    q = torch.cat([x0, q_rest])
    params = torch.tensor([lr, 0.0 if w is None else w])
    g = torch.empty(n)
    fn(q.data_ptr(), target.data_ptr(),
       None if dyn is None else dyn.data_ptr(), params.data_ptr(),
       g.data_ptr())
    var = x0.clone().requires_grad_(True)
    f = ((env._sites_soa(torch.cat([var, q_rest]), dyn)[env._palm_geom]
          - target) ** 2).sum()
    if w is not None:
        f = f + w * (var[1] + var[2] + var[3]) ** 2
    (ref,) = torch.autograd.grad(f, var)
    assert float(((g - ref).abs() / (1.0 + ref.abs())).max()) <= GRAD_TOL
    assert bool((ref != 0).any())
    # a joint the palm does not hang from (a digit) has a zero gradient,
    # exactly, in both
    chain = env._soa.ancestors[int(env._model.sphere_body[env._palm_geom])]
    off = [j for j in range(n) if j not in chain]
    assert bool((g[off] == 0).all()) and bool((ref[off] == 0).all())


@pytest.mark.parametrize("name", ["door-v0-hand", "door-v0-adroit"])
def test_zero_gradient_digit_is_clipped(name):
    _needs_cc()
    env, x0, q_rest, target, lo, hi, dyn, w, lr = _problem(name)
    digit = BODIES[name][5]
    got = _host(env, x0, q_rest, target, lo, hi, dyn, w, lr, 3)
    plain = ik.plain_palm_ik(env, x0, q_rest, target, lo, hi, 3, lr, w, dyn)
    assert float(got[digit]) == float(hi[digit]) == float(plain[digit])


@pytest.mark.parametrize("name", ["door-v0-hand", "door-v0-adroit",
                                  "hammer-v0-adroit"])
def test_nan_target_comes_back_nan(name):
    """A NaN target: after one step the arm is NaN and the digits keep
    their clipped start (their gradient is a zero cotangent through a
    finite FK); after two every entry is NaN, not a stale or partial
    result, in the kernel's build and the plain version alike."""
    _needs_cc()
    env, x0, q_rest, target, lo, hi, dyn, w, lr = _problem(name)
    target = torch.full((3,), float("nan"))
    for iters in (1, 3):
        got = _host(env, x0, q_rest, target, lo, hi, dyn, w, lr, iters)
        plain = ik.plain_palm_ik(env, x0, q_rest, target, lo, hi, iters, lr,
                                 w, dyn)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        assert bool(torch.isnan(got[:4]).all())
        # (the arm-only IK has no digit)
        assert bool(torch.isnan(got).all()) == (iters > 1
                                                or got.shape[0] == 4)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    env, x0, q_rest, target, lo, hi, dyn, w, lr = _problem("door-v0-hand")
    before = LAUNCHES[ik.LAUNCH_KEY]
    got = ik.palm_ik(env, x0, q_rest, target, lo, hi, 2, lr, w, dyn)
    plain = ik.plain_palm_ik(env, x0, q_rest, target, lo, hi, 2, lr, w, dyn)
    assert torch.equal(got, plain)
    assert LAUNCHES[ik.LAUNCH_KEY] == before


def test_headers_are_deterministic_and_count_their_work():
    env = HammerHand()
    text = ik.env_header(env, 4, True)
    assert text == ik.generate_ik_header(env._model, env._palm_geom, 4,
                                         env.scalar_dyn_body, True)
    assert "#define PPI_IK_LEVEL 1" in text and "#define PPI_IK_DYN 1" in text
    ops = ik.ops_per_iteration(env._model, env._palm_geom, 4,
                               env.scalar_dyn_body, True)
    chain = ik.chain_per_iteration(env._model, env._palm_geom, 4,
                                   env.scalar_dyn_body, True)
    assert 0 < chain < ops
    with pytest.raises(ValueError):
        ik.generate_ik_header(env._model, env._palm_geom, 2, None, True)


# ---- on the card ------------------------------------------------------------

def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BODIES))
def test_kernel_matches_plain_on_the_card(name):
    dev = _device()
    env, x0, q_rest, target, lo, hi, dyn, w, lr = (
        x.to(dev) if isinstance(x, torch.Tensor) else x
        for x in _problem(name))
    before = LAUNCHES[ik.LAUNCH_KEY]
    got = ik.palm_ik(env, x0, q_rest, target, lo, hi, 20, lr, w, dyn)
    torch.cuda.synchronize()
    assert LAUNCHES[ik.LAUNCH_KEY] == before + 1
    plain = ik.plain_palm_ik(env, x0, q_rest, target, lo, hi, 20, lr, w, dyn)
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               rtol=0, atol=X_TOL)


@pytest.mark.cuda
def test_kernel_raises_on_a_wrong_operand():
    dev = _device()
    env, x0, q_rest, target, lo, hi, dyn, w, lr = (
        x.to(dev) if isinstance(x, torch.Tensor) else x
        for x in _problem("door-v0-hand"))
    with pytest.raises(TypeError):
        ik.palm_ik(env, x0, q_rest, target.double(), lo, hi, 5, lr, w, dyn)
