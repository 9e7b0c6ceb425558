"""Experiment I/O, logging and the checked device of a run."""

from ppi_tpu_torch.utils.device import checked_device
from ppi_tpu_torch.utils.io import (
    experiment_dir, load_checkpoint, save_checkpoint, save_results,
    write_args)
from ppi_tpu_torch.utils.logs import setup_logging

__all__ = ["checked_device", "experiment_dir", "load_checkpoint",
           "save_checkpoint", "save_results", "setup_logging", "write_args"]
