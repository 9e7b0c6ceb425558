"""Control-quality metrics: FFT smoothness and signal power.

Port of ``ppi_tpu/mpc/metrics.py`` on ``torch.fft``: Sm = 2 * sum(amplitude
* frequency) of the single-sided spectrum (from "Regularizing Action
Policies for Smooth Control with Reinforcement Learning"), evaluated for the
action-norm signal and per-dimension max.
"""

import torch


def _smoothness_1d(signal: torch.Tensor, freqs: torch.Tensor):
    n = signal.shape[0]
    amp = 2.0 * torch.abs(torch.fft.fft(signal)[: n // 2]) / n
    return 2.0 * torch.sum(amp * freqs), amp


def fft_smoothness(action_sequence: torch.Tensor, dt: float):
    """Returns (Sm, per-dim max Sm, spectrum, freqs, action-norm signal)."""
    n, d = action_sequence.shape
    freqs = torch.linspace(0.0, 0.5 / dt, n // 2,
                           device=action_sequence.device)
    per_dim = torch.stack([
        _smoothness_1d(action_sequence[:, i], freqs)[0] for i in range(d)])
    norm_signal = torch.linalg.norm(action_sequence, dim=1)
    sm, spectrum = _smoothness_1d(norm_signal, freqs)
    return sm, torch.max(per_dim), spectrum, freqs, norm_signal


def signal_power(action_sequence: torch.Tensor):
    """Mean L2 norm of the action signal."""
    return torch.linalg.norm(action_sequence, dim=1).mean()
