"""Collectives over one axis of a mesh of ranks, with gradients.

The counterparts of the ``jax.lax`` collectives that
``repro.models.moe``'s ``shard_map`` paths call, for ranks of
``launch.mesh`` joined over gloo. Every transfer is staged through host
memory (page-locked for a tensor on the card, ``core.distributed.
host_copy``), so CPU and CUDA tensors travel alike; every float reduction
is an ordered fold in rank order (``core.distributed.ordered_psum``), so
all ranks hold the same bits.

Two layers:

- the transfers are ``torch.library.custom_op``s (``repro_torch::
  all_to_all``, ``all_gather``, ``gather_seq``, ``scatter_sum_seq``,
  ``gather_fsdp``, ``scatter_sum_fsdp``), so a dispatch mode
  (``launch.cost_analysis.CostCounter``) sees and prices them, a ``meta``
  tensor takes their shape rule and moves nothing, and ``torch.func.vmap``
  has a rule for them (the lanes ride along a dimension the transfer does
  not cut), but for the FSDP pair, which no lane-stacked model runs;
- the differentiable forms are ``torch.autograd.Function``s with
  ``setup_context`` (and a ``vmap`` rule where the op has one): a custom op's
  generated autograd does not compose with ``torch.func.grad`` in this
  torch (it lacks ``setup_context``), and ``launch/steps.py``
  differentiates with ``torch.func.grad_and_value``.

What a backward must do depends on what the axis carries:

- a **model axis** (the experts' ``ep_axis``, tensor parallelism's
  ``"model"``) splits one replicated computation among its peers: every
  peer's loss is the same value, so the cotangent a peer holds of a
  replicated tensor is the whole one. A replicated input that each peer uses
  on its own part of the work (``replicated``, Megatron's f: the input of a
  column split, the experts' tokens; or several in one transfer: the
  whole weights of a layer that each peer reads a block of)
  sums the peers' partial gradients; a sum of the peers' partial outputs
  that every peer then uses whole (``reduce_from_peers``, Megatron's g:
  after a row split) passes its cotangent on as it is; a gathered output
  (``all_gather``) gives each peer back its own block of the cotangent, not
  a sum, which would count every token once a peer. JAX's ``shard_map``
  transpose reaches the same gradients by dividing a replicated output's
  cotangent by the axis size and summing (``psum_scatter``) in the backward.
  A sum whose result each peer uses on its own part only (the Mamba2 gated
  norm's sum of squares) is a ``psum``: its cotangent is partial too;
- **data axes** carry different examples: each rank's loss is its term of
  a mean that the train step completes (``ordered_pmean`` of the
  gradients), so ``psum``'s backward is the ordered sum of the cotangents,
  JAX's transpose of ``psum``;
- a **sequence axis** (context parallelism's ``seq_axis``) carries one
  sequence's blocks, and each rank's loss is its share of a sum that the
  train step completes. ``gather_seq`` hands every peer all the blocks,
  which each uses on its own queries (rank ``r`` reads the prefix up to
  its own block only), so the peers' cotangents differ: its backward is
  the ordered sum of the peers' cotangents, this peer's block of it
  (``scatter_sum_seq``, JAX's ``psum_scatter``, the transpose of an
  ``all_gather``), not ``all_gather``'s own block.

- an FSDP weight (``gather_fsdp``, a layer's leaves in one transfer) is
  cut over the data axes, whose ranks carry different examples: its
  backward is ``gather_seq``'s moved to each weight's cut dimension, this
  rank's block of the ordered sum of the ranks' cotangents
  (``scatter_sum_fsdp``).

``all_to_all`` (equal splits, device-major, ``split_axis = concat_axis =
0``, ``jax.lax.all_to_all(..., tiled=False)``) is its own transpose, and
``gather_seq`` and ``scatter_sum_seq`` are each other's, as are
``gather_fsdp`` and ``scatter_sum_fsdp``.
"""
from __future__ import annotations

import functools
from typing import List

import torch
import torch.distributed as dist

from repro_torch.core.distributed import (gather_parts, host_copy,
                                          host_empty, ordered_psum_op)
from repro_torch.launch.mesh import group_handle, group_of

# What this process's transfers did, summed: "calls" that crossed ranks
# and "sent_bytes" by kind (the operand's bytes, the cost counter's
# measure; for the K/V gathers also the bytes the peers' parts filled).
# Telemetry for the ranks' reports (``chip_smoke.py --mesh-rank``); the
# model never reads it.
COLLECTIVE_COUNTS = {"all-to-all": {"calls": 0, "sent_bytes": 0},
                     "all-gather": {"calls": 0, "sent_bytes": 0},
                     "seq-gather": {"calls": 0, "sent_bytes": 0,
                                    "received_bytes": 0},
                     "seq-scatter": {"calls": 0, "sent_bytes": 0},
                     "fsdp-gather": {"calls": 0, "sent_bytes": 0},
                     "fsdp-scatter": {"calls": 0, "sent_bytes": 0}}


def _count(kind: str, x: torch.Tensor) -> None:
    COLLECTIVE_COUNTS[kind]["calls"] += 1
    COLLECTIVE_COUNTS[kind]["sent_bytes"] += x.numel() * x.element_size()


@torch.library.custom_op("repro_torch::all_to_all", mutates_args=())
def all_to_all_op(x: torch.Tensor, n: int, group: int) -> torch.Tensor:
    """``x`` [n, ...]: block ``i`` goes to peer ``i``; the result's block
    ``i`` came from peer ``i`` (``jax.lax.all_to_all`` with ``split_axis =
    concat_axis = 0``, ``tiled=False``)."""
    host = host_copy(x)
    out = host_empty(host.shape, host)
    dist.all_to_all_single(out, host, group=group_of(group))
    _count("all-to-all", host)
    return out.to(x.device)


@all_to_all_op.register_fake
def _(x, n, group):
    return torch.empty_like(x)


@all_to_all_op.register_vmap
def _(info, in_dims, x, n, group):
    # the peer axis stays first; the lanes ride along dimension 1
    if in_dims[0] is None:
        return all_to_all_op(x, n, group), None
    return all_to_all_op(x.movedim(in_dims[0], 1), n, group), 1


@torch.library.custom_op("repro_torch::all_gather", mutates_args=())
def all_gather_op(x: torch.Tensor, n: int, group: int) -> torch.Tensor:
    """Every peer's ``x`` [m, ...], joined along dimension 0 in rank
    order: [n * m, ...] (``jax.lax.all_gather(..., axis=0, tiled=True)``)."""
    host = host_copy(x)
    out = host_empty((n * host.shape[0],) + tuple(host.shape[1:]), host)
    # the pipelined point-to-point exchange of ordered_psum's parts,
    # received in place (about twice gloo's blocking all_gather's rate)
    gather_parts(host, group_of(group), list(out.chunk(n)))
    _count("all-gather", host)
    return out.to(x.device)


@all_gather_op.register_fake
def _(x, n, group):
    return x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))


@all_gather_op.register_vmap
def _(info, in_dims, x, n, group):
    if in_dims[0] is None:
        return all_gather_op(x, n, group), None
    return all_gather_op(x.movedim(in_dims[0], 1), n, group), 1


@torch.library.custom_op("repro_torch::gather_seq", mutates_args=())
def gather_seq_op(x: torch.Tensor, n: int, group: int) -> torch.Tensor:
    """Every peer's ``x`` [B, m, ...], joined along dimension 1 (the
    sequence) in rank order: [B, n * m, ...]."""
    host = host_copy(x.movedim(1, 0))                  # [m, B, ...]
    out = host_empty((n,) + tuple(host.shape), host)
    gather_parts(host, group_of(group), list(out.unbind(0)))
    _count("seq-gather", host)
    COLLECTIVE_COUNTS["seq-gather"]["received_bytes"] += \
        (out.numel() - host.numel()) * host.element_size()
    return out.flatten(0, 1).to(x.device).movedim(0, 1).contiguous()


@gather_seq_op.register_fake
def _(x, n, group):
    return x.new_empty((x.shape[0], n * x.shape[1]) + tuple(x.shape[2:]))


@gather_seq_op.register_vmap
def _(info, in_dims, x, n, group):
    # the batch and the sequence stay first; the lanes ride along dim 2
    if in_dims[0] is None:
        return gather_seq_op(x, n, group), None
    return gather_seq_op(x.movedim(in_dims[0], 2), n, group), 2


@torch.library.custom_op("repro_torch::scatter_sum_seq", mutates_args=())
def scatter_sum_seq_op(g: torch.Tensor, n: int, group: int) -> torch.Tensor:
    """``g`` [B, n * m, ...] on each of the ``n`` peers: this peer's block
    ``[i m, (i + 1) m)`` of their sum, folded left to right in rank order
    (``jax.lax.psum_scatter(..., scatter_dimension=1, tiled=True)``)."""
    b, s = g.shape[:2]
    host = host_copy(g.reshape((b, n, s // n) + tuple(g.shape[2:]))
                     .movedim(1, 0))                   # [n, B, m, ...]
    parts = host_empty(host.shape, host)
    # block i to peer i; block i of ``parts`` from peer i
    dist.all_to_all_single(parts, host, group=group_of(group))
    _count("seq-scatter", host)
    total = torch.add(parts[0], parts[1], out=host_empty(parts.shape[1:],
                                                         host))
    for part in parts[2:]:
        total.add_(part)
    return total.to(g.device)


@scatter_sum_seq_op.register_fake
def _(g, n, group):
    return g.new_empty((g.shape[0], g.shape[1] // n) + tuple(g.shape[2:]))


@scatter_sum_seq_op.register_vmap
def _(info, in_dims, g, n, group):
    if in_dims[0] is None:
        return scatter_sum_seq_op(g, n, group), None
    return scatter_sum_seq_op(g.movedim(in_dims[0], 2), n, group), 2


def _rows(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``x`` [.., n m, ..] as [n, m x the rest]: peer i's block along
    ``dim`` in row i."""
    moved = x.movedim(dim, 0)
    return moved.reshape(n, -1)


def _unrows(row: torch.Tensor, like_shape, dim: int) -> torch.Tensor:
    """A row of ``_rows``' layout back to a tensor of ``like_shape`` with
    its cut along ``dim``: a tensor of its own (a custom op's outputs may
    not be views of one buffer)."""
    moved = list(like_shape)
    moved.insert(0, moved.pop(dim))
    return row.reshape(moved).movedim(0, dim).clone(
        memory_format=torch.contiguous_format)


def _whole_shape(x: torch.Tensor, n: int, dim: int) -> list:
    shape = list(x.shape)
    shape[dim] *= n
    return shape


@torch.library.custom_op("repro_torch::gather_fsdp", mutates_args=())
def gather_fsdp_op(xs: List[torch.Tensor], n: int, group: int,
                   dims: List[int]) -> List[torch.Tensor]:
    """Every peer's blocks ``xs`` (FSDP weights of one dtype), each joined
    along its ``dims`` entry in rank order: one transfer of all of them
    (a layer's leaves), each peer's blocks flattened into one row."""
    flat = torch.cat([x.movedim(d, 0).reshape(-1) for x, d in zip(xs, dims)])
    host = host_copy(flat)
    out = host_empty((n, host.numel()), host)
    gather_parts(host, group_of(group), list(out.unbind(0)))
    _count("fsdp-gather", host)
    rows = out.to(xs[0].device)                         # [n, all blocks]
    wholes, at = [], 0
    for x, d in zip(xs, dims):
        size = x.numel()
        wholes.append(_unrows(rows[:, at: at + size], _whole_shape(x, n, d),
                              d))
        at += size
    return wholes


@gather_fsdp_op.register_fake
def _(xs, n, group, dims):
    return [x.new_empty(_whole_shape(x, n, d)) for x, d in zip(xs, dims)]


@torch.library.custom_op("repro_torch::scatter_sum_fsdp", mutates_args=())
def scatter_sum_fsdp_op(gs: List[torch.Tensor], n: int, group: int,
                        dims: List[int]) -> List[torch.Tensor]:
    """``gs`` (whole weights' cotangents, one dtype) on each of the ``n``
    peers: this peer's block along each ``dims`` entry of their sum, folded
    left to right in rank order (``jax.lax.psum_scatter(...,
    scatter_dimension=dim, tiled=True)``), in one transfer."""
    host = host_copy(torch.cat([_rows(g, n, d) for g, d in zip(gs, dims)],
                               dim=1))                  # [n, all blocks]
    parts = host_empty(host.shape, host)
    # row i to peer i; row i of ``parts`` from peer i
    dist.all_to_all_single(parts, host, group=group_of(group))
    _count("fsdp-scatter", host)
    total = torch.add(parts[0], parts[1], out=host_empty(parts.shape[1:],
                                                         host))
    for part in parts[2:]:
        total.add_(part)
    total = total.to(gs[0].device)
    blocks, at = [], 0
    for g, d in zip(gs, dims):
        shape = list(g.shape)
        shape[d] //= n
        size = g.numel() // n
        blocks.append(_unrows(total[at: at + size], shape, d))
        at += size
    return blocks


@scatter_sum_fsdp_op.register_fake
def _(gs, n, group, dims):
    out = []
    for g, d in zip(gs, dims):
        shape = list(g.shape)
        shape[d] //= n
        out.append(g.new_empty(shape))
    return out


def _lanes_at(x: torch.Tensor, in_dim, at: int) -> torch.Tensor:
    return x if in_dim is None else x.movedim(in_dim, at)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(x, n, group):
        return all_to_all_op(x, n, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.n, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, n, group):
        return _AllToAll.apply(_lanes_at(x, in_dims[0], 1), n, group), 1


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, n, group, index):
        return all_gather_op(x, n, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.m, ctx.index = inputs[0].shape[0], inputs[3]

    @staticmethod
    def backward(ctx, g):
        # the gathered value is replicated over the axis: this peer's
        # cotangent is the whole one, and its own block is its share
        return g.narrow(0, ctx.index * ctx.m, ctx.m), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, n, group, index):
        return _AllGather.apply(_lanes_at(x, in_dims[0], 1), n, group,
                                index), 1


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(x, n, group):
        return gather_seq_op(x, n, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # each peer read its own part of the blocks: their cotangents are
        # partial, and this peer's block of their sum is its own
        return _ScatterSumSeq.apply(g, ctx.n, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, n, group):
        return _GatherSeq.apply(_lanes_at(x, in_dims[0], 2), n, group), 2


class _ScatterSumSeq(torch.autograd.Function):
    @staticmethod
    def forward(g, n, group):
        return scatter_sum_seq_op(g, n, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _GatherSeq.apply(g, ctx.n, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, g, n, group):
        return _ScatterSumSeq.apply(_lanes_at(g, in_dims[0], 2), n,
                                    group), 2


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(n, group, dims, *xs):
        return tuple(gather_fsdp_op(list(xs), n, group, list(dims)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group, ctx.dims = inputs[:3]

    @staticmethod
    def backward(ctx, *gs):
        # the data ranks carry different examples: their cotangents of the
        # whole weights differ, and this rank's blocks of their sum are its
        # gradients (not all_gather's own block of one cotangent)
        return (None, None, None) + _ScatterSumFsdp.apply(
            ctx.n, ctx.group, ctx.dims, *gs)


class _ScatterSumFsdp(torch.autograd.Function):
    @staticmethod
    def forward(n, group, dims, *gs):
        return tuple(scatter_sum_fsdp_op(list(gs), n, group, list(dims)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group, ctx.dims = inputs[:3]

    @staticmethod
    def backward(ctx, *xs):
        return (None, None, None) + _GatherFsdp.apply(
            ctx.n, ctx.group, ctx.dims, *xs)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(n, group, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group = inputs[:2]

    @staticmethod
    def backward(ctx, *gs):
        # through the Function: under torch.func.grad a backward runs
        # differentiably, and the bare custom op has no usable autograd.
        # Several cotangents go flattened into one row, summed in one
        # transfer, and cut back.
        if len(gs) == 1:
            return None, None, _PSum.apply(gs[0], ctx.n, ctx.group)
        flat = _PSum.apply(torch.cat([g.reshape(-1) for g in gs]), ctx.n,
                           ctx.group)
        return (None, None) + tuple(
            part.view_as(g) for part, g in zip(
                flat.split([g.numel() for g in gs]), gs))

    @staticmethod
    def vmap(info, in_dims, n, group, *xs):
        return _Replicated.apply(n, group, *xs), tuple(in_dims[2:])


class _ReduceFromPeers(torch.autograd.Function):
    @staticmethod
    def forward(x, n, group):
        return ordered_psum_op(x, n, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        # every peer uses the sum whole and holds the same loss: its
        # cotangent is already the whole one on every peer
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, n, group):
        return _ReduceFromPeers.apply(x, n, group), in_dims[0]


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(x, n, group):
        return ordered_psum_op(x, n, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.n, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, n, group):
        return _PSum.apply(x, n, group), in_dims[0]


def _axis(mesh, axis):
    return mesh.axis_size(axis), group_handle(mesh.group(axis))


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` [n, ...] over the ``n`` peers of ``axis``: block ``i`` to peer
    ``i``, block ``i`` of the result from peer ``i``. Its backward is the
    same exchange of the cotangent."""
    n, group = _axis(mesh, axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {n} peers needs x.shape[0] == "
                         f"{n}, got {tuple(x.shape)}")
    return x if n == 1 else _AllToAll.apply(x, n, group)


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every peer's ``x`` joined along dimension 0 in rank order (tiled).
    The result is replicated over ``axis``, so the backward keeps this
    peer's block of the cotangent."""
    n, group = _axis(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, n, group, mesh.axis_index(axis))


def gather_seq(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every peer's sequence block of ``x`` [B, m, ...] joined along
    dimension 1 in rank order: [B, n m, ...] (context parallelism's K/V).
    Each peer uses the result on its own queries, so the backward is this
    peer's block of the ordered sum of the peers' cotangents
    (``scatter_sum_seq``; module docstring)."""
    n, group = _axis(mesh, axis)
    return x if n == 1 else _GatherSeq.apply(x, n, group)


def gather_fsdp(xs: List[torch.Tensor], mesh, axes,
                dims: List[int]) -> List[torch.Tensor]:
    """FSDP weights' wholes from every data rank's blocks ``xs`` (one
    dtype; a layer's leaves), each joined along its ``dims`` entry in rank
    order over ``axes`` (one data axis or a tuple, row-major in the mesh's
    order), all in one transfer. The data ranks carry different examples,
    so the backward is this rank's blocks of the ordered sum of their
    cotangents (a reduce-scatter, ``scatter_sum_fsdp``, again one
    transfer): the gradients summed over the data axes, which
    ``launch.steps`` then only divides by their size."""
    n, group = _axis(mesh, axes)
    if n == 1 or not xs:
        return list(xs)
    if len({x.dtype for x in xs}) != 1:
        raise ValueError(f"gather_fsdp moves one dtype at a time, got "
                         f"{sorted({str(x.dtype) for x in xs})}")
    return list(_GatherFsdp.apply(n, group, tuple(dims), *xs))


def replicated(x, mesh, axis: str):
    """``x`` as it is, held alike by every peer of ``axis``, which each use
    it on their own part of the work: the backward sums the peers' partial
    cotangents in rank order. ``x`` may be a list of tensors of one dtype
    (a layer's whole weights, of which each peer reads its own block):
    their cotangents are summed in one transfer, one ``ordered_psum`` of
    their concatenation, so that each weight's gradient is the whole one,
    the same bits on every peer."""
    n, group = _axis(mesh, axis)
    if isinstance(x, torch.Tensor):
        return x if n == 1 else _Replicated.apply(n, group, x)[0]
    if n == 1 or not x:
        return list(x)
    if len({t.dtype for t in x}) != 1:
        raise ValueError(f"replicated moves one dtype at a time, got "
                         f"{sorted({str(t.dtype) for t in x})}")
    return list(_Replicated.apply(n, group, *x))


def reduce_from_peers(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ordered sum of the peers' partial ``x`` over a model axis (the
    output of a row split), which every peer then uses whole; the backward
    is the identity (module docstring). The transfer is ``repro_torch::
    ordered_psum``, so ``CostCounter`` prices it as an all-reduce of
    ``x``'s bytes."""
    n, group = _axis(mesh, axis)
    return x if n == 1 else _ReduceFromPeers.apply(x, n, group)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``core.distributed.ordered_psum`` with a gradient: the backward is
    the ordered sum of the cotangents over ``axes`` (data axes, or a model
    axis whose sum each peer uses on its own part only)."""
    n, group = _axis(mesh, axes)
    return x if n == 1 else _PSum.apply(x, n, group)


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return psum(x, mesh, axes) / mesh.axis_size(axes)


def mean_of_peers(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of every peer's ``x`` over a model axis (``jax.lax.pmean``),
    folded left to right in rank order; the result is replicated over the
    axis, so each peer's cotangent share is the whole one over ``n``
    (through ``all_gather``'s backward)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    parts = all_gather(x.reshape((1,) + tuple(x.shape)), mesh, axis)
    return functools.reduce(lambda a, b: a + b,
                            [parts[i] for i in range(n)]) / n
