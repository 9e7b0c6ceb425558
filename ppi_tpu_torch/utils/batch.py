"""Episode batches over a leading axis of seeds.

Port of ``ppi_tpu/utils/batch.py``. The JAX package runs a chunk of
episodes as one ``vmap`` over their PRNG keys. The port runs the episodes
of a chunk one after another (``Mpc`` is a host loop), which gives what
the vmapped program gives for each episode; batching a chunk's episodes
into one launch of E x N lanes is not done. ``fn(key)`` returns a tensor
or a tuple of tensors; both functions return them stacked over the keys.
"""

import torch

from ppi_tpu_torch.parallel import gather_costs, shard_bounds


def _stacked(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(xs) for xs in zip(*outs))
    return torch.stack(outs)


def chunked_vmap(fn, keys, chunk=None):
    """``fn`` over the leading axis of ``keys``, stacked. ``chunk`` (the
    JAX package's episodes per vmapped call) changes nothing here: every
    episode runs alone."""
    del chunk
    return _stacked([fn(k) for k in keys])


def sharded_vmap(fn, keys, mesh):
    """``fn`` over the leading axis of ``keys`` with the keys split over
    the ranks of ``mesh`` (``ppi_tpu_torch.parallel``): the keys are padded
    to a multiple of the ranks with the last key, each rank runs its
    contiguous share, one ``all_reduce`` a result (``gather_costs``) gives
    every rank all of them, and the padding is trimmed. Returns what
    ``chunked_vmap(fn, keys)`` returns (a ``-0.0`` comes back ``+0.0``)."""
    n, w = keys.shape[0], mesh.size()
    pad = (-n) % w
    if pad:
        keys = torch.cat([keys, keys[-1:].expand(pad, *keys.shape[1:])])
    lo, hi = shard_bounds(n + pad, mesh)
    local = chunked_vmap(fn, keys[lo:hi])
    gather = lambda x: gather_costs(x, n + pad, mesh)[:n]
    if isinstance(local, tuple):
        return tuple(gather(x) for x in local)
    return gather(local)
