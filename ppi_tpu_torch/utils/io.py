"""Experiment I/O: exists-guarded result directories, argument snapshots
and npz results.

Port of ``experiment_dir``, ``write_args`` and ``save_results`` from
``ppi_tpu/utils/io.py``; tensors are copied to the host as they are saved.
"""

import dataclasses
import json
import logging
from pathlib import Path

import numpy as np
import torch


def experiment_dir(base_dir, name: str, force: bool = False):
    """Create (or reuse) an experiment directory: if results exist and
    ``force`` is False, return None to signal "already done"."""
    path = Path(base_dir) / name
    path.mkdir(parents=True, exist_ok=True)
    if (path / "data.npz").exists() and not force:
        return None
    return path


def write_args(args, path: Path):
    """Snapshot the run arguments next to the results (``args.json``)."""
    if path is None:
        return
    if dataclasses.is_dataclass(args):
        payload = dataclasses.asdict(args)
    elif hasattr(args, "__dict__"):
        payload = dict(vars(args))
    else:
        payload = dict(args)
    payload = {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                   else str(v)) for k, v in payload.items()}
    (Path(path) / "args.json").write_text(json.dumps(payload, indent=2)
                                          + "\n")


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_results(path, **arrays):
    if path is None:
        return
    np.savez(Path(path) / "data.npz",
             **{k: _to_numpy(v) for k, v in arrays.items()})
    logging.info("results -> %s", Path(path) / "data.npz")
