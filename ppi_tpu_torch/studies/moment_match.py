"""The moment-match kernel (``csrc/moment_match.cu``) against ``torch.cov``.

    python -m ppi_tpu_torch.studies.moment_match

In one process on the card: the wrapper's whole call
(``cuda_ops.m_projection_cuda``: its allocation and three launches) in
turns with ``torch.cov`` (the library's nearest call, the weighted
covariance alone), kernel, cov, cov, kernel, ``CALLS`` calls a reading, at
(4096, 640), (16384, 640) and (4096, 64); then each of the wrapper's
launches' device time from ``torch.profiler`` at (4096, 640). Prints one
JSON line with the card's name and power limit from ``nvidia-smi``. Exits
non-zero without a card.
"""

import json
import re
import subprocess
import sys

import numpy as np
import torch

from ppi_tpu_torch.ops.cuda_ops import m_projection_cuda
from ppi_tpu_torch.studies.warp_layout import cuda_ms

TIME_SHAPES = ((4096, 640), (16384, 640), (4096, 64))
CALLS = 100   # calls a reading


def inputs(dev, n, d, seed):
    """chip_smoke.py's inputs: unit normal samples, log-weights at scale 3
    (weights over e^+-9), a quarter of the lanes at -inf."""
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=dev)
    lw = 3.0 * torch.randn(n, generator=g, device=dev)
    lw[torch.randperm(n, generator=g, device=dev)[:n // 4]] = -torch.inf
    return lw, x


def launch_device_us(fn, calls=20):
    """{kernel name: [launches, mean device us]} of the CUDA kernels that
    ``calls`` calls of ``fn`` run, from ``torch.profiler``; raises where the
    profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |\(.*$", "", e.name)
            times.setdefault(name, []).append(e.device_time)
    if not times:
        raise RuntimeError("the profiler saw no kernel on the card")
    return {name: [len(v), float(np.mean(v))] for name, v in times.items()}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("moment_match: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"card": smi, "turns_ms": {}}
    for n, d in TIME_SHAPES:
        lw, x = inputs(dev, n, d, 30)
        w = torch.exp(lw - lw.max())
        calls = {"kernel": lambda: m_projection_cuda(lw, x),
                 "cov": lambda: torch.cov(x.T, correction=0, aweights=w)}
        out["turns_ms"][f"{n}x{d}"] = [
            [name, cuda_ms(calls[name], CALLS, 5)]
            for name in ("kernel", "cov", "cov", "kernel")]
    lw, x = inputs(dev, 4096, 640, 30)
    out["launch_device_us_4096x640"] = launch_device_us(
        lambda: m_projection_cuda(lw, x))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
