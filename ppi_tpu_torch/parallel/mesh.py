"""Sample-axis data parallelism over a ``torch.distributed`` process group.

Counterpart of ``ppi_tpu/parallel/mesh.py``. The JAX package annotates the
sample axis with a mesh sharding and lets XLA place the collectives. Here
each rank is a process (``parallel.launch``), and the one collective is
written out:

  * every rank holds a replica of the policy state: the same seeded
    ``torch.Generator``, the same N sampled plans, the same solver update
    on the same N costs;
  * only the rollout is split: rank i of an axis of W ranks rolls out the
    contiguous plans ``[i*N/W, (i+1)*N/W)`` (``shard_bounds``);
  * ``gather_costs`` gives every rank the full (N,) costs through one
    ``all_reduce(SUM)`` of a vector that is zero outside the rank's shard.
    ``x + 0 + ... + 0 == x`` exactly and the lanes of a rollout are
    independent, so the sharded costs equal the unsharded ones bit for bit
    (a NaN lane stays NaN; ``-0.0`` becomes ``+0.0``, which no later step
    tells apart). NCCL and gloo both reduce CUDA tensors this way (gloo has
    no ``all_gather`` for them).

``Mesh`` is a small frozen dataclass over ``dist.new_group``, not
``torch.distributed.device_mesh.DeviceMesh``: a shard over a tuple of axes
(``("slices", "samples")``, JAX's ``P(axes)``) needs a group over the
flattened axes, which ``DeviceMesh`` offers only through a private method,
and ``DeviceMesh`` makes extra groups of its own over a ``gloo`` world on a
machine with a card. Every group is made when the mesh is, by every rank in
the same order.

``sharded_mpc_objective`` is the eager path on each shard (the counterpart
of the JAX package's XLA-scan path) and the plain version of
``envs.physics.rollout_kernel.sharded_kernel_mpc_objective``, the kernel
on each shard. ``sharded_objective`` shards any black-box or episodic
objective the same way (``runners/run_opt.py`` and
``runners/run_policy_search.py`` with ``--mesh-devices``).
"""

import dataclasses
import itertools
import math
import os
from typing import Sequence, Union

import torch
import torch.distributed as dist

from ppi_tpu_torch.envs.base import batch_rollout, risk_aggregate
from ppi_tpu_torch.parallel.launch import join_group, rank_device

SAMPLE_AXIS = "samples"
SLICE_AXIS = "slices"

Axis = Union[str, Sequence[str]]


def _axes(axis: Axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of the group's ranks with named axes, rank-major in axis order
    (``make_multislice_mesh``: slice-major). ``groups`` maps each set of
    axes to the process group of this rank's ranks along those axes."""

    axis_names: tuple
    sizes: tuple
    rank: int
    device: torch.device
    backend: str
    groups: dict

    @property
    def shape(self) -> dict:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    def _coords(self) -> dict:
        coords, r = {}, self.rank
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            r, coords[name] = divmod(r, size)
        return coords

    def size(self, axis: Axis = SAMPLE_AXIS) -> int:
        """Number of shards along ``axis`` (a name or a tuple of names)."""
        return math.prod(self.shape[a] for a in _axes(axis))

    def coordinate(self, axis: Axis = SAMPLE_AXIS) -> int:
        """This rank's index along ``axis``, flattened in the tuple's order
        (the first name major), as ``P(axes)`` numbers the shards."""
        coords, i = self._coords(), 0
        for a in _axes(axis):
            i = i * self.shape[a] + coords[a]
        return i

    def group(self, axis: Axis = SAMPLE_AXIS):
        return self.groups[frozenset(_axes(axis))]

    def check_device(self, device) -> None:
        """Raise unless ``device`` is this rank's device."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None \
                and self.device.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev != self.device:
            raise ValueError(f"device {device} is not the mesh rank's "
                             f"device {self.device} (rank {self.rank})")


def _world(device) -> int:
    """The group's size; joins the launcher's group under ``torchrun``."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("no process group: start the ranks with "
                             "ppi_tpu_torch.parallel.launch.spawn or torchrun")
        join_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   "env://", device)
    return dist.get_world_size()


def _mesh(axis_names: tuple, sizes: tuple, device) -> Mesh:
    """Every group of the grid, made by every rank in the same order."""
    rank = dist.get_rank()
    grid = list(itertools.product(*(range(s) for s in sizes)))
    groups = {frozenset(axis_names): dist.group.WORLD}
    for k in range(1, len(axis_names)):
        for along in itertools.combinations(range(len(axis_names)), k):
            rest = [d for d in range(len(axis_names)) if d not in along]
            for fixed in itertools.product(*(range(sizes[d]) for d in rest)):
                ranks = [r for r, c in enumerate(grid)
                         if all(c[d] == v for d, v in zip(rest, fixed))]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[frozenset(axis_names[d] for d in along)] = g
    backend = dist.get_backend()
    dev = rank_device(device, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl group needs a CUDA device")
    return Mesh(tuple(axis_names), tuple(sizes), rank, dev, backend, groups)


def make_mesh(n_devices=None, axis: str = SAMPLE_AXIS,
              device="cuda") -> Mesh:
    """1-D mesh over every rank of the process group.

    Raises when the group has fewer ranks than ``n_devices`` -- a
    "multi-chip" mesh quietly shrunk would let sharding checks pass
    vacuously -- and when it has more: a mesh spans the whole group."""
    world = _world(device)
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh(n_devices={n_devices}) but the process group has "
            f"{world} rank(s); start {n_devices} ranks "
            "(ppi_tpu_torch.parallel.launch.spawn or torchrun)")
    return _mesh((axis,), (world,), device)


def make_multislice_mesh(n_slices: int, chips_per_slice: int,
                         slice_axis: str = SLICE_AXIS,
                         sample_axis: str = SAMPLE_AXIS,
                         device="cuda") -> Mesh:
    """2-D ``(slices, samples)`` mesh, slice-major: ranks ``[i*c, (i+1)*c)``
    form slice ``i``. Shard over ``(slice_axis, sample_axis)`` to give each
    slice one contiguous sub-batch; over ``sample_axis`` alone each slice
    rolls out all N and reduces within itself."""
    n = n_slices * chips_per_slice
    world = _world(device)
    if world != n:
        raise ValueError(f"make_multislice_mesh({n_slices}x"
                         f"{chips_per_slice}) needs {n} ranks but the "
                         f"process group has {world}")
    return _mesh((slice_axis, sample_axis), (n_slices, chips_per_slice),
                 device)


def shard_bounds(n: int, mesh: Mesh, axis: Axis = SAMPLE_AXIS):
    """``(lo, hi)``: this rank's contiguous plans ``[i*n/W, (i+1)*n/W)``
    along ``axis`` (replaces ``sample_sharding`` and ``shard_batch``)."""
    w = mesh.size(axis)
    if n % w:
        raise ValueError(f"sharded objective: n_samples={n} must divide "
                         f"evenly over the {w}-rank mesh axis "
                         f"{_axes(axis)}")
    i = mesh.coordinate(axis)
    return i * (n // w), (i + 1) * (n // w)


def gather_costs(local, n: int, mesh: Mesh, axis: Axis = SAMPLE_AXIS):
    """The full (n, ...) rows (the costs, or any per-sample tensor) on every
    rank of ``axis`` from each rank's shard: one ``all_reduce(SUM)`` of a
    tensor that is zero outside it. A float tensor keeps its dtype; any
    other (a success flag) is summed as float32 and cast back, which is
    exact for 0/1 and small integers."""
    lo, hi = shard_bounds(n, mesh, axis)
    dtype = local.dtype if local.is_floating_point() else torch.float32
    full = torch.zeros((n, *local.shape[1:]), dtype=dtype,
                       device=local.device)
    full[lo:hi] = local
    dist.all_reduce(full, group=mesh.group(axis))
    return full.to(local.dtype)


def sharded_objective(f, mesh: Mesh, axis: Axis = SAMPLE_AXIS):
    """Shard the leading (sample) axis of any ``f(generator, actions) ->
    costs`` or ``-> (costs, aux)`` objective over the mesh (the black-box
    functions, the episodic envs): each rank evaluates ``f`` on its rows
    ``shard_bounds(n, mesh, axis)`` and ``gather_costs`` gives every rank
    the full (N,) costs and every per-sample aux tensor (the success flags
    that the solver loop averages over all N).

    Randomness: the generator is a replica, advanced identically on every
    rank. An objective that draws from it (``NoisySphere``'s evaluation
    noise) declares ``takes_rows = True`` and is called with all N actions
    and ``rows=(lo, hi)``: it draws the full (N, ...) noise, as unsharded,
    and returns its rows (``NoisySphere`` computes all N costs and slices
    them, so its sharded run equals the unsharded one at every shape). A
    shard-local draw would give every shard the same noise and advance the
    generator by N/W instead of N. Any other ``f`` sees only its rows, so
    a run on W ranks equals the unsharded run bit for bit wherever ``f``'s
    value of a row does not depend on the batch around it."""

    def g(generator, actions):
        n = actions.shape[0]
        lo, hi = shard_bounds(n, mesh, axis)
        if getattr(f, "takes_rows", False):
            out = f(generator, actions, rows=(lo, hi))
        else:
            out = f(generator, actions[lo:hi])
        if not isinstance(out, tuple):
            return gather_costs(out, n, mesh, axis)
        costs, aux = out
        return (gather_costs(costs, n, mesh, axis),
                {k: gather_costs(v, n, mesh, axis) for k, v in aux.items()})

    return g


def _tensors(tree):
    """The tensors of a dataclass / dict / sequence tree, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _bits(x):
    """``x`` as integers that compare equal only for identical bits."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if not x.is_floating_point():
        return x
    return x.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def replicas_agree(tree, mesh: Mesh) -> bool:
    """Whether every rank's tensors of ``tree`` (a policy state, a carry)
    are bit-identical to rank 0's: rank 0 broadcasts its tensors, each rank
    compares, and one ``all_reduce`` gives every rank the answer."""
    differ = torch.zeros((), dtype=torch.int32, device=mesh.device)
    group = mesh.group(mesh.axis_names)
    for x in _tensors(tree):
        mine = _bits(x.detach()).contiguous()
        ref = mine.clone()
        dist.broadcast(ref, 0, group=group)
        differ += int(not torch.equal(ref, mine))
    dist.all_reduce(differ, group=group)
    return int(differ) == 0


def per_rank(value: float, mesh: Mesh) -> list:
    """Every rank's ``value`` (a launch count, a time), in rank order, on
    every rank: one ``all_reduce`` of a vector that is zero but for this
    rank's entry."""
    group = mesh.group(mesh.axis_names)
    v = torch.zeros(math.prod(mesh.sizes), dtype=torch.float64,
                    device=mesh.device)
    v[mesh.rank] = value
    dist.all_reduce(v, group=group)
    return v.tolist()


def sharded_mpc_objective(env, state0, mesh: Mesh, horizon_mask=None,
                          guard: bool = True, axis: Axis = SAMPLE_AXIS,
                          risk_quantile: float = 1.0,
                          risk_weight: float = 0.0):
    """``f(generator, actions) -> costs`` with the sample axis sharded over
    the mesh: each rank rolls out its shard eagerly
    (``envs.base.batch_rollout``), reduces it with ``risk_aggregate`` (per
    sample, over the unsharded horizon) and gathers the (N,) costs."""

    def f(generator, action_sequences):
        del generator
        n = action_sequences.shape[0]
        lo, hi = shard_bounds(n, mesh, axis)
        _, rewards = batch_rollout(env, state0, action_sequences[lo:hi],
                                   guard)
        return gather_costs(risk_aggregate(rewards, horizon_mask,
                                           risk_quantile, risk_weight),
                            n, mesh, axis)

    return f
