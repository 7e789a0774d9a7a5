"""Meshes of local ranks (``repro/launch/mesh.py:make_debug_mesh``).

A JAX mesh lays the devices of one process out on named axes and
``shard_map`` runs one program per device. The port runs one process per
coordinate instead: the ranks of one ``torch.distributed`` group, laid out
row-major on the axes ``("data", "model")`` or ``("data", "model",
"context")`` as ``jax.make_mesh`` lays out ``jax.devices()`` (rank ``r``
sits at ``numpy.unravel_index(r, shape)``). A :class:`Mesh` holds the
shape, this rank's coordinates, one subgroup per axis of degree above 1
(``dist.new_group``), the group gradients reduce over (data x context:
the ranks that share this rank's model coordinate) and the
:class:`~repro_torch.runtime.collectives.Transport` that moves tensors
between the ranks.

The ``model`` (tensor-parallel) axis runs the column- and row-parallel
products of ``runtime/collectives.py`` over its subgroup, where the JAX
package lets GSPMD place them. A model degree above 1 together with a
context degree above 1 is refused (a later slice).

:func:`make_local_mesh` is the other kind: a data axis inside one process,
with no ranks and no process groups, for what the JAX package runs as one
program over in-process devices (the serving engine's per-replica
shards). Its shards all live on the process's one device.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from datetime import timedelta
from typing import Any

import numpy as np
import torch.distributed as dist

from repro_torch.runtime.sharding import LATER_SLICE_TP_CONTEXT


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over local ranks. ``groups`` maps each axis of degree
    above 1 to the subgroup of the ranks that differ from this one only
    along it; ``sync_group`` spans data x context (the ranks of this
    rank's model coordinate); a mesh of one rank has no groups (and needs
    no process group)."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    sync_group: Any = None
    comm: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh lacks)."""
        if axis not in self.axis_names:
            return 0
        return int(np.unravel_index(self.rank, self.shape)[self.axis_names.index(axis)])

    def group(self, axis: str):
        return self.groups.get(axis)


def _axis_groups(shape, axis_names, rank, timeout):
    """One ``new_group`` per line of ranks along each axis of degree above
    1; every rank creates every group, in the same order, as
    ``dist.new_group`` requires. Returns this rank's group per axis."""
    mine = {}
    for ai, axis in enumerate(axis_names):
        if shape[ai] == 1:
            continue
        others = [range(d) for j, d in enumerate(shape) if j != ai]
        for rest in itertools.product(*others):
            ranks = []
            for c in range(shape[ai]):
                idx = list(rest)
                idx.insert(ai, c)
                ranks.append(int(np.ravel_multi_index(idx, shape)))
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine[axis] = g
    return mine


def _sync_group(shape, axis_names, rank, timeout):
    """The data x context group of this rank: the ranks that share its
    model coordinate. The whole process group when the model degree is 1;
    else one ``new_group`` per model coordinate, which every rank creates
    in the same order."""
    mi = axis_names.index("model")
    if shape[mi] == 1:
        return dist.group.WORLD
    mine = None
    for m in range(shape[mi]):
        ranks = [r for r in range(math.prod(shape))
                 if np.unravel_index(r, shape)[mi] == m]
        g = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            mine = g
    return mine


def make_debug_mesh(data: int = 1, model: int = 1, context: int = 1, *,
                    timeout: float | None = None) -> Mesh:
    """The mesh of this process group: ``(data, model)``, with a third
    ``context`` axis when ``context > 1`` (ring attention), as the JAX
    ``make_debug_mesh``. A mesh of one rank needs no process group;
    otherwise the group (``launch.ranks`` starts it) must hold exactly
    ``data * model * context`` ranks. ``timeout``: seconds for each
    subgroup's collectives (the group's default otherwise)."""
    from repro_torch.runtime.collectives import Transport

    if model > 1 and context > 1:
        raise NotImplementedError(LATER_SLICE_TP_CONTEXT)
    if context > 1:
        axes, shape = ("data", "model", "context"), (data, model, context)
    else:
        axes, shape = ("data", "model"), (data, model)
    n = math.prod(shape)
    if n < 1:
        raise ValueError(f"mesh shape {shape} must be positive")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks {shape} needs torch.distributed initialised "
                f"with {n} ranks (repro_torch.launch.ranks.spawn_ranks starts them)")
        return Mesh(axes, shape, comm=Transport())
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} holds {n} ranks; the process "
                         f"group has {world}")
    rank = dist.get_rank()
    td = None if timeout is None else timedelta(seconds=timeout)
    groups = _axis_groups(shape, axes, rank, td)
    return Mesh(axes, shape, rank, groups, _sync_group(shape, axes, rank, td), Transport())


def make_local_mesh(data: int = 1) -> Mesh:
    """A ``(data, 1)`` mesh inside this process: no ranks, no process
    groups, every shard on the caller's one device (the JAX
    ``make_debug_mesh(data, 1)`` over in-process devices)."""
    if data < 1:
        raise ValueError(f"the data degree must be positive, got {data}")
    return Mesh(("data", "model"), (data, 1))


def is_local_mesh(mesh: Mesh) -> bool:
    """True for a mesh of one process (no process groups): the data axis
    of :func:`make_local_mesh`, or the one-rank mesh of
    :func:`make_debug_mesh`."""
    return not mesh.groups and mesh.sync_group is None
