"""Receding-horizon MPC on the PPI solver stack (torch)."""

from ppi_tpu_torch.mpc.agent import Mpc, MpcCarry

__all__ = ["Mpc", "MpcCarry"]
