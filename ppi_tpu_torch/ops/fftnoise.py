"""Power-law (1/f^beta) Gaussian noise by spectral synthesis.

Port of ``ppi_tpu/ops/fftnoise.py``: scale the rFFT spectrum of white
Gaussian noise by f^(-beta/2), normalize to unit output variance and
transform back (``torch.fft.irfft``). The two normal draws of the spectrum
(``sr``, ``si``) are split off from the deterministic synthesis
(``powerlaw_from_normals``), so a test can feed both packages the same
draws. Everything stays on the draws' device.
"""

import torch


def powerlaw_from_normals(sr, si, beta: float, n: int) -> torch.Tensor:
    """Noise with S(f) ~ f^-beta along the last axis (length ``n``) from the
    standard-normal real and imaginary parts ``sr``, ``si`` (..., n//2+1)."""
    f = torch.fft.rfftfreq(n, device=sr.device)
    # the f=0 pole reuses the first nonzero frequency's amplitude
    amp = torch.where(f == 0.0, f[1], f) ** (-beta / 2.0)
    # unit variance: the DC bin carries none, and the Nyquist bin (even n)
    # is real only, so it counts at half weight
    var_w = amp[1:] ** 2
    if n % 2 == 0:
        var_w = torch.cat([var_w[:-1], 0.5 * var_w[-1:]])
    sigma = 2.0 * torch.sqrt(torch.sum(var_w)) / n
    # a real signal needs real DC (and Nyquist, for even n) components
    k = torch.arange(f.shape[0], device=f.device)
    real_only = (k == 0) | (k == n // 2) if n % 2 == 0 else k == 0
    imag_mask = (~real_only).to(f.dtype)
    spectrum = torch.complex(sr * amp, si * amp * imag_mask)
    return torch.fft.irfft(spectrum, n=n, dim=-1) / sigma


def powerlaw_psd_gaussian(generator: torch.Generator, beta: float, shape,
                          device=None) -> torch.Tensor:
    """Gaussian noise with S(f) ~ f^-beta along the LAST axis of ``shape``
    (beta 0 white, 1 pink, 2 red). ``sr`` is drawn before ``si``."""
    shape = tuple(shape)
    n = shape[-1]
    if n == 1:
        return torch.randn(shape, generator=generator, device=device)
    fshape = shape[:-1] + (n // 2 + 1,)
    sr = torch.randn(fshape, generator=generator, device=device)
    si = torch.randn(fshape, generator=generator, device=device)
    return powerlaw_from_normals(sr, si, beta, n)
