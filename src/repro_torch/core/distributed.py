"""The mule-sharded engine's pieces: configuration, collectives, the
population's bucketing and its moves between ranks.

Mapping (the reference's ``core/distributed.py``):

- the mule population is cut into equal blocks over the mesh's ``data``
  axis (``launch.mesh.make_mule_mesh``); every rank holds one block, and
  the ranks of one data index in different pods hold the same block;
- physical areas map to pods (the paper's near-isolated cities);
- fixed-device models, the freshness sketch and the clock are small and
  replicated: each rank computes its mules' contributions to the
  aggregation, and one ``ordered_psum`` a step combines them;
- a cross-area mule moves by ``migrate_mules``, a ring permutation of
  mule state over the pod axis.

``make_distributed_method_step`` lowers the one method table
(``core.method_program``) to the rank-local step the engine replays.

Every float reduction across ranks is an ``ordered_psum``: an all-gather
of every rank's part through host memory (gloo, point to point in
pipelined pieces), then a left-to-right fold in rank order, so every rank computes bitwise the same sum, and the
sum does not depend on the transport. A part on the card is staged in
page-locked host memory (``host_copy``, ``host_empty``), and the fold
runs on the host before the one copy back (float addition rounds alike
on the host and on the card, so the bits are those of a fold there). Integer reductions (the bucket
order's area gather) are exact in any order.

Two collective schedules (``DistributedConfig.cross_pod``):

- ``True``: the fixed devices are replicated everywhere and the payload
  sums over (``pod``, ``data``); each pod adds its copy of the mules, and
  the means (and the sketch, divided back by the pod count) come out the
  same;
- ``False``: the sum runs over ``data`` only, inside each pod.

Bucketing: a rank holds one equal block of the population, and the ring
(``repro_torch.baselines.gossip.ring_encounter_mix``) can skip a hop only
when the two blocks share no area. Ordering the mules by area at build time
makes the blocks area-contiguous, which is what lets the pruning bite:
interleaved areas leave every area on every rank and nothing to prune.
``bucket_mule_order`` gives the permutation, ``reorder_colocation`` and
``reorder_mule_state`` apply it to the schedule and to the population (the
same simulation with the mules renumbered), and
``bucket_locality_fraction`` measures how much of the encounter work the
local hop serves. The schedule helpers are numpy, as the schedules are.
``global_bucket_order`` is the mid-run form over the ranks' blocks.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.freshness import (FreshnessConfig, age_histogram,
                                        init_freshness_sketch)
from repro_torch.core.population import PopulationConfig
from repro_torch.interop import tree_map
from repro_torch.kernels.mule_agg.ops import lanes_first
from repro_torch.launch.mesh import group_handle, group_of


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    pop: PopulationConfig
    data_axis: str = "data"
    pod_axis: str = "pod"          # "": a mesh without pods
    cross_pod: bool = True         # the collective schedule (module doc)
    # the ring's exact area-bitmask hop pruning (False: the dense ring)
    ring_prune: bool = True
    # width of the ring's area bitmask; 0 picks it per run: 32 bits, 64
    # once an area id reaches 32 (more areas than bits alias and stop the
    # pruning, never its soundness)
    ring_bits: int = 0
    # mid-run re-bucketing: every `rebucket_every` steps (on a chunk
    # boundary of the streamed engine) the share of mules whose area left
    # their bucket is read; past `rebucket_threshold` the mules are put in
    # a new bucket order across the ranks. 0: bucketing at build time only
    rebucket_every: int = 0
    rebucket_threshold: float = 0.25


def _tree_mix(a, b, gamma):
    """``(1 - g) x + g y`` on every leaf, ``gamma`` per leading row."""
    def mix(x, y):
        g = gamma.reshape(gamma.shape + (1,) * (x.dim() - gamma.dim()))
        return (1.0 - g) * x + g * y
    return tree_map(mix, a, b)


# What this process's ordered_psum calls did, summed: "calls" that crossed
# ranks and "sent_bytes" (its part times the other ranks that receive it).
# Telemetry for chip_smoke.py's distributed phase; the engine never reads it.
PSUM_COUNTS = {"calls": 0, "sent_bytes": 0}


def host_copy(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host, contiguous, for gloo: a copy in page-locked
    memory (the caching host allocator keeps the blocks) when ``x`` is on
    the card, so the copies each way run at the link's rate."""
    x = x.detach()
    if x.device.type != "cuda":
        return x.contiguous()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def host_empty(shape, like: torch.Tensor) -> torch.Tensor:
    """An empty host buffer for a transfer of ``like``'s dtype, page-locked
    when ``like`` is (``host_copy``)."""
    return torch.empty(shape, dtype=like.dtype,
                       pin_memory=like.is_pinned())


def ordered_psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of the mesh ``axes``, the same bits on
    every rank: an all-gather through host memory (pure data movement),
    then a left-to-right fold in rank order on ``x``'s device. A float sum
    in the order of a backend's all-reduce would differ from rank to rank
    and from one transport to another; the fold's order depends on the
    mesh alone. Under ``torch.func.vmap`` (a seed sweep) the lanes travel
    stacked in one all-gather (``ordered_psum_op``)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    return ordered_psum_op(x, n, group_handle(mesh.group(axes)))


# The parts of an ordered_psum cross the ranks in pieces of at most
# _EXCHANGE_PIECE bytes, _EXCHANGE_WINDOW pieces in flight, each rank
# sending its piece to every peer and receiving theirs point to point: over
# gloo on one host that moves about 3x the bytes a second of a blocking
# all_gather (1.1 against 0.36 GB/s a rank, 2-rank groups, H100 host)
_EXCHANGE_PIECE = 32 << 20
_EXCHANGE_WINDOW = 4


def _gather_parts(host: torch.Tensor, group) -> list:
    """Every rank's ``host`` (contiguous, on the host), in the group's rank
    order: an all-gather by pairwise exchange, piece by piece."""
    ranks = (list(range(dist.get_world_size())) if group is None
             else dist.get_process_group_ranks(group))
    me = dist.get_rank()
    parts = [host if r == me else host_empty(host.shape, host)
             for r in ranks]
    flat = [p.view(-1) for p in parts]
    mine = host.view(-1)
    step = max(1, _EXCHANGE_PIECE // host.element_size())
    pending = collections.deque()
    for tag, at in enumerate(range(0, host.numel(), step)):
        ops = []
        for r, f in zip(ranks, flat):
            if r != me:
                ops.append(dist.P2POp(dist.isend, mine[at: at + step], r,
                                      group=group, tag=tag))
                ops.append(dist.P2POp(dist.irecv, f[at: at + step], r,
                                      group=group, tag=tag))
        pending.append(dist.batch_isend_irecv(ops))
        if len(pending) >= _EXCHANGE_WINDOW:
            for work in pending.popleft():
                work.wait()
    for works in pending:
        for work in works:
            work.wait()
    return parts


@torch.library.custom_op("repro_torch::ordered_psum", mutates_args=())
def ordered_psum_op(x: torch.Tensor, n: int, group: int) -> torch.Tensor:
    """``ordered_psum`` over the ``n`` ranks of the process group named
    ``group`` (``launch.mesh.group_handle``), a custom op so that
    ``torch.func.vmap`` can see it."""
    host = host_copy(x)
    parts = _gather_parts(host, group_of(group))
    PSUM_COUNTS["calls"] += 1
    PSUM_COUNTS["sent_bytes"] += host.numel() * host.element_size() * (n - 1)
    # left to right, in rank order, into a buffer of its own (this rank's
    # part may be ``x`` itself)
    total = torch.add(parts[0], parts[1], out=host_empty(host.shape, host))
    for part in parts[2:]:
        total.add_(part)
    return total.to(x.device)


@ordered_psum_op.register_fake
def _(x, n, group):
    return torch.empty_like(x)


@ordered_psum_op.register_vmap
def _(info, in_dims, x, n, group):
    # the fold is elementwise, so the lane-stacked sum is each lane's
    if in_dims[0] is None:
        return ordered_psum_op(x, n, group), None
    return ordered_psum_op(lanes_first(x, in_dims[0], info.batch_size), n,
                           group), 0


def ordered_pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``ordered_psum`` over the number of ranks it summed."""
    return ordered_psum(x, mesh, axes) / mesh.axis_size(axes)


def global_bucket_order(area_last: torch.Tensor, mesh,
                        data_axis: str = "data"):
    """The bucket order of the population from this rank's block of the
    current areas: the blocks of every rank gathered in rank order (int32,
    exact), then a stable argsort, so every rank holds the same ``(order,
    area)`` and ``order`` is ``np.argsort(area, kind="stable")``."""
    from repro_torch.launch.multiprocess import gather_global
    full = gather_global(area_last.to(torch.int32), mesh, 0, data_axis)
    return torch.argsort(full, stable=True), full


def init_distributed_freshness(n_fixed: int, cfg: FreshnessConfig,
                               device) -> dict:
    """Replicated freshness state of the distributed engine, per
    ``cfg.stat``."""
    if cfg.stat == "median":
        return init_freshness_sketch(n_fixed, cfg, device)
    if cfg.stat == "meanstd":
        return {"threshold": torch.full((n_fixed,), cfg.init_threshold,
                                        dtype=torch.float32, device=device)}
    raise ValueError(f"unknown freshness stat {cfg.stat!r}; "
                     "expected 'median' or 'meanstd'")


def to_distributed_state(state: Dict[str, Any],
                         dcfg: DistributedConfig) -> Dict[str, Any]:
    """An ``init_population`` state for the distributed engine.

    Swaps the exact ring's freshness state for the one
    ``dcfg.pop.freshness.stat`` picks, carrying the threshold over and (for
    the sketch) binning the ring's resident ages, so no history is lost.
    """
    cfg = dcfg.pop.freshness
    old = state.get("fresh", {})
    dev = state["t"].device
    fresh = init_distributed_freshness(dcfg.pop.n_fixed, cfg, dev)
    if "threshold" in old:
        fresh["threshold"] = old["threshold"]
    if cfg.stat == "median" and "ages" in old:
        valid = old["ages"] < 1e29
        fresh["hist"] = age_histogram(old["ages"], valid.float(), cfg)
        fresh["count"] = old["count"]
    return {**state, "fresh": fresh}


def make_distributed_method_step(method: str, train_fn: Callable,
                                 dcfg: DistributedConfig, mesh) -> Callable:
    """The rank-local one-step update of the distributed engine.

    The one method table (``core.method_program``) lowered for ranks: the
    ``(state, info, batches, key) -> state`` signature of ``compile_step``,
    but every mule array is this rank's block ([M_loc, ...], M_loc =
    n_mules / data-axis size), with ``fixed_models``, ``fresh`` and ``t``
    replicated (``to_distributed_state``). ``mlmule`` runs the fused
    reduce with one ``ordered_psum`` a step; the peer methods stream their
    encounter search around the data axis's ring (``RingSpec``); ``local``
    needs no collective. Per-mule seeds are the global split's slice, so a
    rank's draws are single host's, row for row.
    """
    from repro_torch.core.method_program import (compile_distributed_step,
                                                 get_program)
    return compile_distributed_step(get_program(method), train_fn, dcfg,
                                    mesh)


def migrate_mules(mule_models: Dict[str, torch.Tensor],
                  move_mask: torch.Tensor, mesh, pod_axis: str = "pod",
                  data_axis: str = "data") -> Dict[str, torch.Tensor]:
    """Cross-area transport: each flagged mule slot of this rank's block
    takes the same slot of the previous pod's block (a ring permutation
    over the pod axis: pod ``p`` sends to ``p + 1``), the paper's
    inter-city traveller. ``n_pods`` swaps walk a slot around the ring
    back to its origin, so they round-trip bitwise."""
    from repro_torch.baselines.gossip import RingSpec, _ring_shift
    n_pods = mesh.shape[pod_axis]
    if n_pods == 1:
        recv = mule_models
    else:
        ring = RingSpec(n_pods, group=mesh.group(pod_axis))
        recv = _ring_shift(mule_models, 1, ring).wait()

    def one(leaf, got):
        m = move_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(m, got, leaf)
    return tree_map(one, mule_models, recv)


def migrate_mule_state(state: Dict[str, Any], move_mask: torch.Tensor,
                       mesh, pod_axis: str = "pod",
                       data_axis: str = "data") -> Dict[str, Any]:
    """``migrate_mules`` over every ``mule*`` entry of the state (models,
    timestamps, any per-mule carry), so a moved mule keeps its own history;
    replicated entries pass through."""
    moving = {k: v for k, v in state.items()
              if k.startswith("mule") and v is not None}
    if not moving:
        return dict(state)
    return {**state, **migrate_mules(moving, move_mask, mesh,
                                     pod_axis=pod_axis, data_axis=data_axis)}


def bucket_mule_order(area) -> np.ndarray:
    """Area ids -> [M] permutation grouping mules by spatial bucket.

    Takes the static [M] areas or a time-varying [T, M] trace, of which it
    uses the t = 0 row. A stable sort, so the order within a bucket (and
    the identity when every mule shares one area) is kept.
    """
    a = np.asarray(area)
    if a.ndim == 2:
        a = a[0]
    return np.argsort(a, kind="stable")


def reorder_colocation(colocation: Dict[str, Any],
                       order: np.ndarray) -> Dict[str, Any]:
    """Apply a mule permutation to every per-mule colocation column.

    Values that are [T, M, ...] (fixed_id, exchange, active, a time-varying
    area, pos [T, M, 2]) or [M] (static area, init_space) follow ``order``
    on the axis whose length matches it; anything else passes through.
    """
    order = np.asarray(order)

    def one(v):
        a = np.asarray(v)
        if a.ndim >= 2 and a.shape[1] == order.shape[0]:
            return a[:, order]
        if a.ndim >= 1 and a.shape[0] == order.shape[0]:
            return a[order]
        return a
    return {k: one(v) for k, v in colocation.items()}


def _rows(tree: Any, order: np.ndarray) -> Any:
    if isinstance(tree, dict):
        return {k: _rows(v, order) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rows(v, order) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree[torch.as_tensor(order, device=tree.device)]
    return np.asarray(tree)[order]


def reorder_mule_state(state: Dict[str, Any], order) -> Dict[str, Any]:
    """Apply a mule permutation to the per-mule state.

    Every ``mule*`` entry (models, timestamps, freshness carry; tensors or
    numpy arrays) has its rows follow their colocation columns
    (``reorder_colocation``), so a bucket-ordered run is the same
    simulation with the mules renumbered; other entries pass through.
    """
    order = np.asarray(order, dtype=np.int64)
    return {k: (_rows(v, order) if k.startswith("mule") and v is not None
                else v)
            for k, v in state.items()}


def bucket_locality_fraction(area, n_shards: int) -> float:
    """Fraction of same-area ordered mule pairs that are rank-local under
    the equal-block layout of ``area`` over ``n_shards`` ranks.

    Same-area pairs are the candidate encounters the ring must cover, so
    this is the share of encounter work the local hop can serve; 1.0 when
    there are no same-area pairs. Blocks are ``np.array_split``'s, so a
    population that does not divide ``n_shards`` counts its ragged tail.
    """
    a = np.asarray(area)
    if a.ndim == 2:
        a = a[0]
    local = total = 0
    blocks = np.array_split(a, n_shards)
    for u in np.unique(a):
        c = int((a == u).sum())
        total += c * (c - 1)
        for blk in blocks:
            ck = int((blk == u).sum())
            local += ck * (ck - 1)
    return float(local) / float(total) if total else 1.0
