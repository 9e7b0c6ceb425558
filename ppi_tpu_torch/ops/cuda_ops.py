"""The hand-written CUDA kernel of the Gaussian moment match.

Counterpart of ``ppi_tpu/ops/pallas_ops.py``. ``m_projection_cuda`` runs
the whole weighted moment match -- weight exponentiation, the weighted
first and second moments of the centred samples and the ESS sums -- in one
kernel (``ppi_tpu_torch/csrc/moment_match.cu``, two passes, no atomics),
built with ``nvcc`` for ``sm_90a`` at first use and bound with ``ctypes``.

Single-pass formulation (shift by max(log_w), centre by the batch mean):
    w_i = exp(log_w_i - shift)          W = sum w        W2 = sum w^2
    S1  = sum w_i (x_i - c)             S2 = sum w_i (x_i - c)(x_i - c)^T
    mu  = S1 / W + c      sigma = sym(S2 / W - mu_c mu_c^T)      ess = W^2 / W2

``m_projection_plain`` is the same formula in torch f32: the wrapper takes
it for CPU tensors only; for a CUDA tensor it launches the kernel or
raises. ``LAUNCHES["moment_match"]`` counts the launches.
"""

import functools

import torch

from ppi_tpu_torch.build import LAUNCHES, build_library, load_function

TILE, CHUNK = 64, 32   # as MM_TILE and MM_CHUNK in moment_match.cu
SM_COUNT = 132         # an H100's SMs: pass 1 aims at 4 blocks on each


def plan(n: int, d: int):
    """(rows, splits): pass 1 splits N into ``splits`` ranges of ``rows``
    rows (a multiple of the 32-row chunk). From the shape only: enough
    blocks to fill the card, and at least 64 rows a split."""
    t = -(-d // TILE)
    pairs = t * (t + 1) // 2
    splits = max(1, min(-(-4 * SM_COUNT // pairs), -(-n // 64)))
    rows = -(-(-(-n // splits)) // CHUNK) * CHUNK
    return rows, -(-n // rows)


def _moments(s1, s2, w_total, w_sq, centre):
    """The epilogue: (mu, sigma, ess) from the centred sums."""
    mu_c = s1 / w_total
    sigma = s2 / w_total - torch.outer(mu_c, mu_c)
    sigma = 0.5 * (sigma + sigma.T)
    return mu_c + centre, sigma, w_total * w_total / w_sq


def m_projection_plain(log_w: torch.Tensor, samples: torch.Tensor):
    """What the kernel computes, in torch f32: (mu (d,), sigma (d, d),
    ess ())."""
    w = torch.exp(log_w - torch.max(log_w))
    centre = samples.mean(0)
    xc = samples - centre
    xw = xc * w[:, None]
    return _moments(xw.sum(0), xw.T @ xc, w.sum(), (w * w).sum(), centre)


def _check(log_w, samples):
    if samples.dim() != 2 or log_w.shape != samples.shape[:1]:
        raise ValueError(f"shapes log_w {tuple(log_w.shape)}, samples "
                         f"{tuple(samples.shape)}; expected (N,) and (N, d)")
    n, d = samples.shape
    if n == 0 or d == 0 or n * d >= 2 ** 31:
        raise ValueError(f"samples {tuple(samples.shape)}: need N, d > 0 "
                         "and N * d < 2^31")
    for name, x in (("log_w", log_w), ("samples", samples)):
        if x.dtype != torch.float32 or x.device != samples.device:
            raise TypeError(f"{name}: expected float32 on {samples.device}, "
                            f"got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _kernel(host: bool):
    """The built and loaded launcher (``host``: the host-C build)."""
    if host:
        return load_function(build_library("moment_match.cu", host=True),
                             "ppi_mm_host", 8, 4, stream=False)
    return load_function(build_library("moment_match.cu"), "ppi_mm_launch",
                         8, 4, stream=True)


def _launch(fn, log_w, samples, stream=None):
    """Run ``fn`` (the CUDA launcher or the host-C build) on ``samples``'
    device: returns (s1, s2, w_total, w_sq, centre)."""
    n, d = samples.shape
    rows, splits = plan(n, d)
    shift = torch.max(log_w).reshape(1)
    centre = samples.mean(0)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=samples.device)
    s2p, s1p, s2, s1w = (new(splits, d, d), new(splits, d + 2), new(d, d),
                         new(d + 2))
    ptrs = [t.data_ptr() for t in (log_w, samples, centre, shift, s2p, s1p,
                                   s2, s1w)]
    extra = () if stream is None else (stream,)
    err = fn(*ptrs, n, d, rows, splits, *extra)
    if err != 0:
        raise RuntimeError(f"moment-match kernel launch failed: CUDA error "
                           f"{err}")
    return s1w[:d], s2, s1w[d], s1w[d + 1], centre


def m_projection_cuda(log_w: torch.Tensor, samples: torch.Tensor):
    """Weighted Gaussian moment match (mu, sigma, ess): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.

    log_w: (N,) f32 unnormalized log-weights (may hold -inf; not all);
    samples: (N, d) f32, C-contiguous, on the same device."""
    dev = samples.device
    if dev.type == "cpu":
        return m_projection_plain(log_w, samples)
    if dev.type != "cuda":
        raise TypeError(f"no moment-match kernel for {dev}")
    _check(log_w, samples)
    with torch.cuda.device(dev):
        sums = _launch(_kernel(False), log_w, samples,
                       torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["moment_match"] += 1
    return _moments(*sums)


def m_projection_host(log_w: torch.Tensor, samples: torch.Tensor):
    """The kernel's host-C build (``cc``) on CPU tensors: the same blocks,
    chunk loads, accumulation order and pass-2 sums, one after the other.
    For the CPU tests of the kernel's partition and masking."""
    _check(log_w, samples)
    return _moments(*_launch(_kernel(True), log_w, samples))
