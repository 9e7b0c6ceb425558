"""Experiment I/O: exists-guarded result directories, argument snapshots,
npz results and checkpoints.

Port of ``experiment_dir``, ``write_args``, ``save_results``,
``save_checkpoint`` and ``load_checkpoint`` from ``ppi_tpu/utils/io.py``;
tensors are copied to the host as they are saved. Where the JAX package
stores a PRNG key's data, a checkpoint here stores a ``torch.Generator``'s
state (``get_state``), so a resumed run draws what the uninterrupted run
would have.
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


def _leaves(tree):
    """The tensors and generators of a dataclass / dict / sequence tree, in
    field order (anything else is structure, taken from the tree)."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (list, tuple)):
        return []
    return [leaf for x in tree for leaf in _leaves(x)]


def _rebuild(tree, leaves):
    """``tree`` with its tensors and generators replaced, in ``_leaves``'s
    order, by the next of the iterator ``leaves``."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return tree


def save_checkpoint(path, tree, step: int = 0):
    """Write a tree of tensors and generators (policy state, generator,
    counters) to one npz: tensors as arrays, a generator as its state."""
    payload = {}
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Generator):
            payload[f"generator_{i}"] = leaf.get_state().numpy()
        else:
            payload[f"leaf_{i}"] = _to_numpy(leaf)
    payload["__step"] = np.asarray(step)
    with open(Path(path), "wb") as fh:
        np.savez(fh, **payload)


def load_checkpoint(path, like_tree):
    """Restore a checkpoint into the structure of ``like_tree``: each
    tensor on its like's device and dtype, each generator a new one on its
    like's device in the saved state. Returns (tree, step)."""
    with np.load(Path(path)) as data:
        restored = []
        for i, like in enumerate(_leaves(like_tree)):
            if isinstance(like, torch.Generator):
                gen = torch.Generator(like.device)
                gen.set_state(torch.from_numpy(data[f"generator_{i}"]))
                restored.append(gen)
            else:
                restored.append(torch.from_numpy(data[f"leaf_{i}"]).to(
                    device=like.device, dtype=like.dtype))
        step = int(data["__step"])
    return _rebuild(like_tree, iter(restored)), step
