"""Gossip Learning (Hegedűs et al. 2019).

Per encounter: exchange-aggregate-train. Mobile devices within ``radius``
of each other in the same area exchange models, average with all
neighbors (masked row-normalized mixing), then train one local step.

The neighbor average is the fused ``encounter_mix`` op
(``repro_torch.kernels.encounter_mix``): models flatten once to an [M, D]
float32 matrix and one pass computes the distance-tested, row-normalized
mix — on a CUDA tensor the hand-written kernel. The former dense path
(``encounter_matrix`` + per-leaf ``masked_group_mean``) survives below only
as the baseline it was replaced by.

Sharded populations: with a ``RingSpec`` each rank of a
``torch.distributed`` process group holds one equal block of the
population, and the mix runs as a ring (``ring_encounter_mix``). Hop ``s``
sends the rank's original (pos, area, active, flattened models) block
straight to rank ``(i + s) % n`` and receives rank ``(i - s) % n``'s with
one ``all_to_all_single`` per tensor (``shift_perm``); each hop's
unnormalized ``encounter_block_hop`` partial (the hop kernel on a CUDA
tensor) is added in hop order and the rows are normalized once at the end,
so no rank ever holds the full [M, M] matrix. The ring is locality-aware:
each rank publishes a 32- or 64-bit area-set summary (one tiny
``all_reduce`` per exchange, so every rank holds the same hop mask), and
every remote hop whose source and destination area sets cannot intersect
skips both its transfer and its compute. A pruned hop would have added
exactly zero, so pruned and unpruned rings agree bitwise, and since the
mask is replicated every rank skips the same collectives. The next hop's
transfer is issued (``async_op=True``) before the block in hand is
consumed, so transfers overlap the compute. Each collective is a custom
op (``ring_need_op``, ``ring_shift_op``) whose ``torch.func.vmap`` rule
sends the lane-stacked tensor of a seed sweep in one collective.

Mules should be ordered by spatial bucket for the pruning to bite
(``repro_torch.core.distributed.bucket_mule_order``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.aggregation import batched_mix, masked_group_mean
from repro_torch.core.seeds import split
from repro_torch.interop import tree_map
from repro_torch.kernels.encounter_mix import (encounter_gate,
                                               encounter_hop_op,
                                               encounter_mix_op,
                                               encounter_mix_reference,
                                               normalize_mix)
from repro_torch.kernels.encounter_mix.ref import radius_sq
from repro_torch.kernels.mule_agg.ops import lanes_first
from repro_torch.launch.mesh import group_handle, group_of

Params = Dict[str, torch.Tensor]
# sorted leaf keys, per-leaf shapes (without the population axis), dtypes
FlatSpec = Tuple[List[str], List[torch.Size], List[torch.dtype]]

N_AREA_BITS = 32

# What the rings of this process did, summed over calls: "hops" computed
# (the local hop included), remote hops "pruned", and "sent_bytes" handed
# to the transport. Telemetry for chip_smoke.py's ring phase and the ring
# tests; the ring itself never reads it.
RING_COUNTS = {"hops": 0, "pruned": 0, "sent_bytes": 0}


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """The ring of ranks for cross-rank encounter search.

    ``axis_size`` is the number of ranks of ``group``, a
    ``torch.distributed`` process group (``None``: the default group); each
    rank holds one equal block of the population, rank ``i`` the rows from
    ``i * m_loc``. ``prune`` enables the area-bitmask hop pruning (exact, so
    on by default). ``n_bits`` is the area-summary width: area ids fold
    with ``% n_bits``, so more than ``n_bits`` distinct areas alias bits
    and lose pruning power, never soundness.
    """
    axis_size: int
    group: Any = None
    prune: bool = True
    n_bits: int = N_AREA_BITS

    def perm(self) -> List[Tuple[int, int]]:
        return [(s, (s + 1) % self.axis_size) for s in range(self.axis_size)]

    def shift_perm(self, s: int) -> List[Tuple[int, int]]:
        """Pairs (source, destination) delivering rank j's block to rank
        (j + s) % n — after the shift every rank i holds rank (i - s) % n's
        block."""
        return [(j, (j + s) % self.axis_size)
                for j in range(self.axis_size)]

    def rank(self) -> int:
        """This process's index on the ring; checks the group's size. A
        one-rank ring (a mesh axis of size 1) needs no process group."""
        if self.axis_size == 1:
            return 0
        size = dist.get_world_size(self.group)
        if size != self.axis_size:
            raise ValueError(f"RingSpec.axis_size is {self.axis_size}, its "
                             f"process group has {size} ranks")
        return dist.get_rank(self.group)


def area_bits(area: torch.Tensor, active: Optional[torch.Tensor] = None,
              n_bits: int = N_AREA_BITS) -> torch.Tensor:
    """[..., m] int areas (+ optional [..., m] active mask) -> [..., n_bits]
    bool summary.

    Bit ``b`` is set iff some active row has ``area % n_bits == b``. Hash
    collisions (areas ``n_bits`` apart) can only add bits, so a predicate
    built on these summaries may keep a skippable hop but never prunes a
    hop whose blocks truly share an area.
    """
    hit = ((area[..., :, None] % n_bits)
           == torch.arange(n_bits, device=area.device))
    if active is not None:
        hit = hit & active[..., :, None]
    return hit.any(dim=-2)


def hops_needed(all_bits: torch.Tensor) -> torch.Tensor:
    """[..., n_ranks, n_bits] per-rank area summaries -> [..., n_ranks]
    bool.

    Entry ``s`` answers: does any rank's area set intersect that of its
    shift-``s`` source ``(i - s) % n``? Entry 0, the local block, is True
    whenever any rank has an active mule.
    """
    n = all_bits.shape[-2]
    return torch.stack([(all_bits & torch.roll(all_bits, s, dims=-2))
                        .flatten(-2).any(-1) for s in range(n)], dim=-1)


def ring_hop_mask(area, active, n_shards: int,
                  n_bits: int = N_AREA_BITS) -> torch.Tensor:
    """Host-side mirror of the in-ring pruning predicate.

    Splits the global ``area``/``active`` rows (numpy or tensors) into
    ``n_shards`` equal blocks, the ring's layout, and returns the
    [n_shards] bool hop mask the pruned ring computes.
    """
    area = torch.as_tensor(area)
    active = None if active is None else torch.as_tensor(active)
    m_loc = area.shape[0] // n_shards
    blocks = []
    for k in range(n_shards):
        sl = slice(k * m_loc, (k + 1) * m_loc)
        blocks.append(area_bits(area[sl],
                                None if active is None else active[sl],
                                n_bits=n_bits))
    return hops_needed(torch.stack(blocks))


def area_bit_collision_rate(area, n_bits: int = N_AREA_BITS) -> float:
    """Fraction of distinct area ids that share their summary bit with
    another distinct id under the ``% n_bits`` fold (0.0: the bitmask
    separates every area). Telemetry: aliased areas can only keep hops."""
    u = np.unique(np.asarray(area))
    if u.size == 0:
        return 0.0
    bits = u % n_bits
    _, counts = np.unique(bits, return_counts=True)
    collided = int(counts[counts > 1].sum())
    return float(collided) / float(u.size)


def _ring_need(area: torch.Tensor, act: torch.Tensor, ring: RingSpec):
    """The replicated [axis_size] hop mask: ``(lane, union)``, a bool tensor
    and the same as a list on the host. Under ``torch.func.vmap`` (a seed
    sweep) ``lane`` is each lane's own mask and ``union`` the hops any lane
    needs, which every lane runs (``ring_need_op``)."""
    lane, union = ring_need_op(area, act, ring.axis_size, ring.n_bits,
                               ring.rank(), group_handle(ring.group))
    return lane, union.tolist()


def _need_table(area: torch.Tensor, act: torch.Tensor, n: int, n_bits: int,
                rank: int, group: int) -> torch.Tensor:
    """[S, n] hop masks of S lanes of blocks ([S, m] areas and activity).

    Each rank writes its lanes' area summaries into its row of an [S, n,
    n_bits] table; one ``all_reduce(SUM)`` gives every rank the same table,
    so every rank prunes the same hops and issues the same collectives.
    """
    table = torch.zeros((area.shape[0], n, n_bits), dtype=torch.int64)
    table[:, rank] = area_bits(area, act, n_bits=n_bits).cpu()
    dist.all_reduce(table, op=dist.ReduceOp.SUM, group=group_of(group))
    return hops_needed(table > 0)


@torch.library.custom_op("repro_torch::ring_need", mutates_args=())
def ring_need_op(area: torch.Tensor, act: torch.Tensor, n: int, n_bits: int,
                 rank: int, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hop mask of this rank's block (area [m], act [m] bool) on a ring
    of ``n`` ranks, twice: (the lane's, the union of the lanes')."""
    need = _need_table(area[None], act[None], n, n_bits, rank, group)[0]
    return need, need.clone()


@ring_need_op.register_fake
def _(area, act, n, n_bits, rank, group):
    return (area.new_empty((n,), dtype=torch.bool),
            area.new_empty((n,), dtype=torch.bool))


@ring_need_op.register_vmap
def _(info, in_dims, area, act, n, n_bits, rank, group):
    k = info.batch_size
    need = _need_table(lanes_first(area, in_dims[0], k),
                       lanes_first(act, in_dims[1], k), n, n_bits, rank,
                       group)
    return (need, need.any(0)), (0, None)


class _Shift:
    """A ring shift in flight: ``wait()`` returns the received block."""

    def __init__(self, received: Any, works: list):
        self.received, self.works = received, works

    def wait(self) -> Any:
        for w, _keep in self.works:
            w.wait()
        return self.received


# transfers that ring_shift_op started, each with the tensor it reads;
# _ring_shift hands them to the _Shift that waits for them
_STARTED: List[Tuple[Any, torch.Tensor]] = []


def _ring_shift(orig: Any, s: int, ring: RingSpec) -> _Shift:
    """Send every tensor of ``orig`` to rank ``(i + s) % n`` and receive
    rank ``(i - s) % n``'s, one asynchronous ``all_to_all_single`` per
    tensor (``ring_shift_op``; under ``torch.func.vmap`` each tensor's lanes
    travel stacked in one). Every rank holds a block of the same shapes."""
    first = len(_STARTED)
    g = group_handle(ring.group)
    received = tree_map(
        lambda t: ring_shift_op(t, s, ring.axis_size, ring.rank(), g), orig)
    works = _STARTED[first:]
    del _STARTED[first:]
    return _Shift(received, works)


@torch.library.custom_op("repro_torch::ring_shift", mutates_args=())
def ring_shift_op(x: torch.Tensor, s: int, n: int, rank: int,
                  group: int) -> torch.Tensor:
    """Start sending ``x`` whole to rank ``(rank + s) % n`` of the group
    named ``group`` and receiving rank ``(rank - s) % n``'s into the tensor
    returned, which is valid once the transfer pushed on ``_STARTED`` has
    been waited for (``bool`` travels as ``uint8``)."""
    src = x.contiguous()
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    buf = torch.empty_like(wire)
    rows = wire.shape[0]
    send_to = [rows if j == (rank + s) % n else 0 for j in range(n)]
    recv_from = [rows if j == (rank - s) % n else 0 for j in range(n)]
    _STARTED.append((dist.all_to_all_single(buf, wire, recv_from, send_to,
                                            group=group_of(group),
                                            async_op=True), wire))
    RING_COUNTS["sent_bytes"] += wire.numel() * wire.element_size()
    return buf.view(torch.bool) if src.dtype == torch.bool else buf


@ring_shift_op.register_fake
def _(x, s, n, rank, group):
    return torch.empty_like(x)


@ring_shift_op.register_vmap
def _(info, in_dims, x, s, n, rank, group):
    if in_dims[0] is None:
        return ring_shift_op(x, s, n, rank, group), None
    return ring_shift_op(lanes_first(x, in_dims[0], info.batch_size), s, n,
                         rank, group), 0


def _ring_shifts(orig: Any, ring: RingSpec, need: Optional[List[bool]]):
    """(hop s, source rank, visiting block) of hops s = 1 .. n-1 in order,
    skipping pruned hops; hop s+1's transfer is issued before hop s's
    block is handed out (double buffering)."""
    n = ring.axis_size
    i = ring.rank()

    def issue(s):
        if need is not None and not need[s]:
            RING_COUNTS["pruned"] += 1
            return None
        return _ring_shift(orig, s, ring)

    nxt = issue(1)
    for s in range(1, n):
        blk = nxt
        if s + 1 < n:       # issue the next transfer before consuming
            nxt = issue(s + 1)
        if blk is not None:
            yield s, (i - s) % n, blk.wait()


def flatten_population(models: Params) -> Tuple[torch.Tensor, FlatSpec]:
    """Stacked dict [M, ...] -> (f32 [M, D] matrix, unflatten spec).

    Columns follow the sorted dotted keys, which is ``jax.tree.flatten``'s
    leaf order of the reference's nested pytree.
    """
    keys = sorted(models)
    m = models[keys[0]].shape[0]
    flat = torch.cat([models[k].reshape(m, -1).float() for k in keys], dim=1)
    return flat, (keys, [models[k].shape[1:] for k in keys],
                  [models[k].dtype for k in keys])


def unflatten_population(flat: torch.Tensor, spec: FlatSpec) -> Params:
    keys, shapes, dtypes = spec
    out, off = {}, 0
    for k, s, dt in zip(keys, shapes, dtypes):
        n = math.prod(s)
        out[k] = flat[:, off:off + n].reshape((flat.shape[0],) + s).to(dt)
        off += n
    return out


def encounter_matrix(pos: torch.Tensor, area: torch.Tensor, radius: float,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pos [M,2], area [M] -> symmetric bool [M,M] (no self).

    The retired dense path. ``active`` ([M] bool, optional) drops
    switched-off mules from both sides of every encounter.
    """
    d2, gate = encounter_gate(pos, area, active, 0, pos, area, active, 0)
    return (d2 <= radius_sq(radius).to(pos.device)) & gate


def _neighbor_mix(flat, pos, area, active, radius, backend):
    if backend == "auto":      # the custom op: one launch for vmapped lanes
        return encounter_mix_op(pos, area, active, flat, radius)
    if backend == "ref":
        return encounter_mix_reference(pos, area, active, flat, radius=radius)
    raise ValueError(f"unknown encounter backend {backend!r}; expected "
                     "'auto' or 'ref'")


def ring_encounter_mix(pos: torch.Tensor, area: torch.Tensor,
                       active: Optional[torch.Tensor], flat: torch.Tensor, *,
                       radius: float, ring: RingSpec, backend: str = "auto"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise ``encounter_mix`` across the ring of ranks.

    Every argument is this rank's block ([m_loc, ...], the same m_loc on
    every rank). Hop 0 matches the local rows against the local block; hop
    ``s`` against the block received from rank ``(i - s) % n``, whose
    global rows start at ``((i - s) % n) * m_loc``. The unnormalized
    partials (``encounter_block_hop``, with ``backend``) are summed in hop
    order, ``acc = acc + p_acc`` for s = 1 .. n-1, into the local hop's
    buffers, and normalized once. With ``ring.prune`` a hop the replicated
    area mask rules out skips its transfer and its compute. Under
    ``torch.func.vmap`` (a seed sweep) every lane runs the hops that any
    lane needs; a hop that one lane does not need meets no pair in that
    lane, so its partial is +0 everywhere, and adding +0 to sums that start
    from +0 (never -0) changes no bit. Returns the local rows' (mix
    [m_loc, D], mass [m_loc]).
    """
    m_loc = flat.shape[0]
    row0 = ring.rank() * m_loc
    act = (torch.ones((m_loc,), dtype=torch.bool, device=pos.device)
           if active is None else active)
    orig = (pos, area, act, flat)

    def hop(visiting, col0):
        pos_v, area_v, act_v, flat_v = visiting
        RING_COUNTS["hops"] += 1
        return encounter_hop_op(pos, area, act, row0, pos_v, area_v, act_v,
                                col0, flat_v, radius, backend)

    acc, mass = hop(orig, row0)                     # shift 0: local block
    if ring.axis_size > 1:
        need = _ring_need(area, act, ring)[1] if ring.prune else None
        for _, src, blk in _ring_shifts(orig, ring, need):
            p_acc, p_mass = hop(blk, src * m_loc)
            acc.add_(p_acc)
            mass.add_(p_mass)
    return normalize_mix(acc, mass), mass


def gossip_step(models: Params, pos: torch.Tensor, area: torch.Tensor,
                batches: Any, train_fn: Callable, key: int, *,
                radius: float = 0.15, gamma: float = 0.5,
                active: Optional[torch.Tensor] = None,
                backend: str = "auto", ring: Optional[RingSpec] = None,
                keys: Optional[torch.Tensor] = None) -> Params:
    """One gossip exchange-aggregate-train step over the population.

    ``backend="auto"`` mixes with ``encounter_mix`` (the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor); ``"ref"`` always runs
    the plain version. With a ``RingSpec`` every argument is this rank's
    block and neighbors stream around the ring (``ring_encounter_mix``;
    ``backend`` then selects the hop's kernel or plain version). Each mule
    trains with its own seed of ``split(key, M)``, or of ``keys`` [M] when
    given (a rank passes its slice of the global split, so its draws match
    single host row for row); only mules that met a peer take the result.
    """
    flat, spec = flatten_population(models)
    if ring is None:
        mixed, mass = _neighbor_mix(flat, pos, area, active, radius, backend)
    else:
        mixed, mass = ring_encounter_mix(pos, area, active, flat,
                                         radius=radius, ring=ring,
                                         backend=backend)
    neigh_mean = unflatten_population(mixed, spec)
    met = (mass > 0).float()
    models = batched_mix(models, neigh_mean, gamma * met)           # aggregate
    if keys is None:
        keys = split(key, mass.shape[0], mass.device)
    trained = torch.func.vmap(train_fn)(models, batches, keys)      # train
    return batched_mix(models, trained, met)                # only on encounter


def gossip_step_dense(models: Params, pos: torch.Tensor, area: torch.Tensor,
                      batches: Any, train_fn: Callable, key: int, *,
                      radius: float = 0.15, gamma: float = 0.5,
                      active: Optional[torch.Tensor] = None) -> Params:
    """The retired dense gossip step: [M, M] matrix + per-leaf group mean.

    A baseline only; it normalizes the encounter matrix *before* the
    per-leaf matmuls, so it differs from ``gossip_step`` in float rounding,
    not semantics.
    """
    enc = encounter_matrix(pos, area, radius, active).float()
    neigh_mean, mass = masked_group_mean(models, enc, backend="ref")
    met = (mass > 0).float()
    models = batched_mix(models, neigh_mean, gamma * met)
    keys = split(key, mass.shape[0], mass.device)
    trained = torch.func.vmap(train_fn)(models, batches, keys)
    return batched_mix(models, trained, met)
