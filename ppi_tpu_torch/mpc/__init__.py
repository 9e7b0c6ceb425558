"""Receding-horizon MPC on the PPI solver stack (torch)."""

from ppi_tpu_torch.mpc.agent import Mpc, MpcCarry
from ppi_tpu_torch.mpc.metrics import fft_smoothness, signal_power

__all__ = ["Mpc", "MpcCarry", "fft_smoothness", "signal_power"]
