"""The (pod, data) mesh of ranks for the mule-sharded engine.

The port's counterpart of the reference's ``jax.sharding.Mesh``: the ranks
of the ``torch.distributed`` world laid out row-major as ``(pod, data)``,
rank ``r`` at ``(r // data, r % data)``. The mule population is cut into
``data`` equal blocks along the data axis, block ``j`` held by every rank
of data index ``j``; the pods hold copies (the reference shards mules over
the data axis alone). A rank runs collectives over one axis (its pod's
ranks along ``data``, or its data index's ranks along ``pod``) or over
both, and ``MuleMesh.group`` gives the process group of each.

``dist.new_group`` must be called by every rank in the same order, so
``make_mule_mesh`` builds the groups of every pod and every data index on
every rank, and keeps each mesh it built: every rank asks for the same
meshes in the same order, so they all find them again together. A
one-rank mesh needs no process group at all ("k = 1 shards nothing").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch.distributed as dist

Axes = Union[str, Sequence[str]]

_MESHES: Dict[Tuple, "MuleMesh"] = {}
# process groups named by an int, for custom ops, which take no Python
# objects; handle 0 is the default group
_GROUPS: List[Any] = [None]


@dataclasses.dataclass(frozen=True, eq=False)
class MuleMesh:
    """``shape`` maps each axis name to its size, pod axis first;
    ``coords`` this rank's index on each; ``groups`` the process group of
    each axis and of the tuple of both (``None``: the default group);
    ``data_axis`` the axis the mules are cut along."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[Any, Any]
    data_axis: str

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        names = tuple(a for a in names if a)
        unknown = set(names) - set(self.shape)
        if unknown:
            raise ValueError(f"mesh axes {sorted(self.shape)} have no "
                             f"{sorted(unknown)}")
        # the mesh's own order, so ("data", "pod") folds as ("pod", "data")
        return tuple(a for a in self.shape if a in names)

    def axis_size(self, axes: Axes) -> int:
        n = 1
        for a in self._key(axes):
            n *= self.shape[a]
        return n

    def group(self, axes: Axes):
        """Process group of ``axes`` (one name or several); ``None`` for the
        default group or a one-rank axis."""
        return self.groups.get(self._key(axes))


def group_handle(group) -> int:
    """The int that names ``group`` (``None``: the default group, 0) to the
    collective custom ops; ``group_of`` turns it back."""
    for i, g in enumerate(_GROUPS):
        if g is group:
            return i
    _GROUPS.append(group)
    return len(_GROUPS) - 1


def group_of(handle: int):
    return _GROUPS[handle]


def _world() -> Tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def make_mule_mesh(pod: int, data: int, *, pod_axis: str = "pod",
                   data_axis: str = "data") -> MuleMesh:
    """The ``(pod, data)`` mesh over every rank of the world.

    ``pod * data`` must equal the world size (1 without a process group);
    ``pod_axis=""`` builds the data-only mesh a pod-less
    ``DistributedConfig`` expects (then ``pod`` must be 1).
    """
    if not pod_axis and pod != 1:
        raise ValueError(f"pod={pod} needs a pod axis name")
    world, rank = _world()
    if pod * data != world:
        raise ValueError(f"mesh {pod} x {data} needs {pod * data} ranks, "
                         f"the world has {world}")
    key = (pod, data, pod_axis, data_axis, world)
    if key in _MESHES:
        return _MESHES[key]
    p, j = divmod(rank, data)
    shape = ({pod_axis: pod} if pod_axis else {}) | {data_axis: data}
    coords = ({pod_axis: p} if pod_axis else {}) | {data_axis: j}

    def group(ranks):
        # every rank makes the same calls; a group of the whole world is
        # the default group, a group of one rank needs none
        if len(ranks) == world or len(ranks) == 1:
            return None
        return dist.new_group(ranks)

    groups: Dict[Any, Any] = {}
    for q in range(pod):                      # the data axis of each pod
        g = group([q * data + k for k in range(data)])
        if q == p:
            groups[(data_axis,)] = g
    if pod_axis:
        for k in range(data):                 # the pod axis of each index
            g = group([q * data + k for q in range(pod)])
            if k == j:
                groups[(pod_axis,)] = g
        groups[(pod_axis, data_axis)] = None  # the whole world
    mesh = MuleMesh(shape=shape, coords=coords, groups=groups,
                    data_axis=data_axis)
    _MESHES[key] = mesh
    return mesh
