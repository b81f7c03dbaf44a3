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

The LM stack's ``(data, model)`` mesh (``make_lm_mesh``) is the same
layout under other names: rank ``r`` at ``(r // model, r % model)``, as
``jax.sharding.Mesh`` lays ``devices.reshape(data, model)`` out, the batch
cut over ``data`` and the mixture-of-experts' experts over ``model``.

A mesh may lay out a list of the world's ranks (``ranks=``, as
``jax.sharding.Mesh`` takes any list of devices): its groups are made on
every rank of the world, in the same order, and a rank outside the list
gets ``None`` for the mesh.

``make_production_mesh`` is the reference's production mesh, (data 256 /
tp, model tp) or (pod 2, data 256 / tp, model tp), as one rank of it sees
it: its coordinates and no process groups. It drives nothing across
ranks; the dry run counts that rank's step on ``meta``, where every
collective is a custom op whose shape rule moves nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def axis_index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, row-major over them in the
        mesh's order (``jax.lax.axis_index`` of a tuple of axes)."""
        i = 0
        for a in self._key(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

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
                   data_axis: str = "data",
                   ranks: Optional[Sequence[int]] = None
                   ) -> Optional[MuleMesh]:
    """The ``(pod, data)`` mesh over every rank of the world, or over the
    world's ``ranks`` in that order (``None`` on a rank outside them).

    ``pod * data`` must equal the number of ranks laid out (the world size,
    1 without a process group, by default); ``pod_axis=""`` builds the
    data-only mesh a pod-less ``DistributedConfig`` expects (then ``pod``
    must be 1).
    """
    if not pod_axis and pod != 1:
        raise ValueError(f"pod={pod} needs a pod axis name")
    world, rank = _world()
    members = tuple(range(world)) if ranks is None else tuple(ranks)
    if pod * data != len(members):
        raise ValueError(f"mesh {pod} x {data} needs {pod * data} ranks, "
                         f"{'the world has' if ranks is None else 'given'} "
                         f"{len(members)}")
    if len(set(members)) != len(members) or \
            not set(members) <= set(range(world)):
        raise ValueError(f"ranks {list(members)} are not distinct ranks of "
                         f"the world of {world}")
    key = (pod, data, pod_axis, data_axis, world, members)
    if key in _MESHES:
        return _MESHES[key]
    made: Dict[Tuple[int, ...], Any] = {}

    def group(local):
        # every rank of the world makes the same calls; a group of the
        # whole world is the default group, a group of one rank needs none
        ranks_ = tuple(members[i] for i in local)
        if ranks_ == tuple(range(world)) or len(ranks_) == 1:
            return None
        if ranks_ not in made:
            made[ranks_] = dist.new_group(list(ranks_))
        return made[ranks_]

    inside = rank in members
    p, j = divmod(members.index(rank) if inside else 0, data)
    shape = ({pod_axis: pod} if pod_axis else {}) | {data_axis: data}
    coords = ({pod_axis: p} if pod_axis else {}) | {data_axis: j}

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
        # every rank laid out
        groups[(pod_axis, data_axis)] = group(range(len(members)))
    mesh = MuleMesh(shape=shape, coords=coords, groups=groups,
                    data_axis=data_axis) if inside else None
    _MESHES[key] = mesh
    return mesh


def make_lm_mesh(data: int, model: int, *, data_axis: str = "data",
                 model_axis: str = "model",
                 ranks: Optional[Sequence[int]] = None
                 ) -> Optional[MuleMesh]:
    """The ``(data, model)`` mesh of the LM stack over every rank of the
    world, or over its ``ranks`` (``None`` on a rank outside them):
    ``make_mule_mesh``'s groups with the data axis in the pod axis's place
    and the model axis in the data axis's."""
    return make_mule_mesh(data, model, pod_axis=data_axis,
                          data_axis=model_axis, ranks=ranks)


POD_CHIPS = 256     # the reference's production pod


def make_production_mesh(*, multi_pod: bool = False,
                         model_parallel: int = 16,
                         rank: int = 0) -> MuleMesh:
    """Rank ``rank`` of the reference's production mesh (``repro.launch.
    mesh.make_production_mesh``): ``(data, model)`` = (256 / tp, tp), or
    ``(pod, data, model)`` = (2, 256 / tp, tp), the rank's coordinates
    row-major over them as ``jax.sharding.Mesh`` lays devices out. A
    stand-in: it holds no process group, so it runs only a count on
    ``meta`` (``launch.dryrun``)."""
    tp = model_parallel
    if tp < 1 or POD_CHIPS % tp:
        raise ValueError(f"model_parallel={tp} does not divide the "
                         f"{POD_CHIPS} chips of a pod")
    return stand_in_mesh(({"pod": 2} if multi_pod else {})
                         | {"data": POD_CHIPS // tp, "model": tp}, rank)


def stand_in_mesh(shape: Dict[str, int], rank: int = 0) -> MuleMesh:
    """Rank ``rank`` of a mesh of ``shape`` (axis: size, in the mesh's
    order), row-major over the axes, with no process groups: what a count
    on ``meta`` needs of one rank (``make_production_mesh``, and a small
    mesh to hold such a count against real ranks)."""
    size = 1
    for n in shape.values():
        size *= n
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not one of the mesh's {size}")
    coords, rest = {}, rank
    for axis in reversed(tuple(shape)):
        rest, coords[axis] = divmod(rest, shape[axis])
    return MuleMesh(shape=dict(shape), coords={a: coords[a] for a in shape},
                    groups={}, data_axis=tuple(shape)[-1])
