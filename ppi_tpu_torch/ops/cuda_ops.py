"""The hand-written CUDA kernel of the Gaussian moment match.

Counterpart of ``ppi_tpu/ops/pallas_ops.py``. ``m_projection_cuda`` runs
the whole weighted moment match -- weight exponentiation, the weighted
first and second moments of the centred samples, the ESS sums and the
epilogue -- in three launches of ``ppi_tpu_torch/csrc/moment_match.cu``
(prologue: column sums and the max log-weight; main: S2 on the tensor
cores in three TF32 products a term, reduced over a thread-block cluster;
epilogue: mu, sigma and ESS), no atomics, built with ``nvcc`` for
``sm_90a`` at first use and bound with ``ctypes``. The wrapper allocates
one buffer and runs no other device operation.

Single-pass formulation (shift by max(log_w), centre by the batch mean):
    w_i = exp(log_w_i - shift)          W = sum w        W2 = sum w^2
    S1  = sum w_i (x_i - c)             S2 = sum w_i (x_i - c)(x_i - c)^T
    mu  = S1 / W + c      sigma = sym(S2 / W - mu_c mu_c^T)      ess = W^2 / W2

``m_projection_plain`` is the same formula in torch f32: the wrapper takes
it for CPU tensors only; for a CUDA tensor it launches the kernel or
raises. ``LAUNCHES["moment_match"]`` counts the calls.
"""

import functools

import torch

from ppi_tpu_torch.build import LAUNCHES, build_library, load_function

CHUNK = 32             # as MM_CHUNK in moment_match.cu
MAX_CLUSTER = 8        # the most blocks of a portable thread-block cluster
SM_COUNT = 132         # an H100's SMs: the main kernel aims at one block each
PART_ROWS_MIN, MAX_PARTS = 256, 32   # the prologue's row partition


def plan(n: int, d: int):
    """(tile, rows, splits, parts, part_rows), from the shape only.

    The main kernel computes ``tile`` x ``tile`` tiles of the upper
    triangle (128, or 64 for d <= 64), each over a cluster of ``splits``
    blocks, rank s summing rows [s * rows, (s + 1) * rows) (a multiple of
    the 32-row chunk): enough blocks to fill the card, at most 8 a
    cluster, at least 64 rows a block. The prologue splits N into
    ``parts`` ranges of ``part_rows`` rows."""
    tile = 64 if d <= 64 else 128
    t = -(-d // tile)
    pairs = t * (t + 1) // 2
    splits = max(1, min(MAX_CLUSTER, -(-SM_COUNT // pairs), -(-n // 64)))
    rows = -(-(-(-n // splits)) // CHUNK) * CHUNK
    parts = max(1, min(MAX_PARTS, -(-n // PART_ROWS_MIN)))
    part_rows = -(-n // parts)
    return tile, rows, -(-n // rows), -(-n // part_rows), part_rows


def m_projection_plain(log_w: torch.Tensor, samples: torch.Tensor):
    """What the kernel computes, in torch f32: (mu (d,), sigma (d, d),
    ess ())."""
    w = torch.exp(log_w - torch.max(log_w))
    centre = samples.mean(0)
    xc = samples - centre
    xw = xc * w[:, None]
    w_total = w.sum()
    mu_c = xw.sum(0) / w_total
    sigma = (xw.T @ xc) / w_total - torch.outer(mu_c, mu_c)
    sigma = 0.5 * (sigma + sigma.T)
    return mu_c + centre, sigma, w_total * w_total / (w * w).sum()


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
                             "ppi_mm_host", 3, 7, stream=False)
    return load_function(build_library("moment_match.cu"), "ppi_mm_launch",
                         3, 7, stream=True)


def _launch(fn, log_w, samples, stream=None):
    """Run ``fn`` (the CUDA launcher or the host-C build) on ``samples``'
    device: returns (mu, sigma, ess), views of one buffer that also holds
    the kernels' scratch."""
    n, d = samples.shape
    tile, rows, splits, parts, part_rows = plan(n, d)
    out = torch.empty(d * d + d + 1 + parts * (d + 1) + 2 * d + 2,
                      dtype=torch.float32, device=samples.device)
    extra = () if stream is None else (stream,)
    err = fn(log_w.data_ptr(), samples.data_ptr(), out.data_ptr(), n, d,
             tile, rows, splits, parts, part_rows, *extra)
    if err != 0:
        raise RuntimeError(f"moment-match kernel launch failed: CUDA error "
                           f"{err}")
    return out[d * d:d * d + d], out[:d * d].view(d, d), out[d * d + d]


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
        moments = _launch(_kernel(False), log_w, samples,
                          torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES["moment_match"] += 1
    return moments


def m_projection_host(log_w: torch.Tensor, samples: torch.Tensor):
    """The kernels' host-C build (``cc``) on CPU tensors, the CPU model of
    the design: the same prologue, tile pairs, cluster ranks, chunks, TF32
    split, products of 8 samples and reduction orders, one after the
    other. For the CPU tests of the kernel's partition, masking and
    precision."""
    _check(log_w, samples)
    return _launch(_kernel(True), log_w, samples)

