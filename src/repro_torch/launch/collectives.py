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
  all_to_all``, ``repro_torch::all_gather``), so a dispatch mode
  (``launch.cost_analysis.CostCounter``) sees and prices them, a ``meta``
  tensor takes their shape rule and moves nothing, and ``torch.func.vmap``
  has a rule for them (the lanes ride along a dimension the transfer does
  not cut);
- the differentiable forms are ``torch.autograd.Function``s with
  ``setup_context`` and a ``vmap`` rule around them: a custom op's
  generated autograd does not compose with ``torch.func.grad`` in this
  torch (it lacks ``setup_context``), and ``launch/steps.py``
  differentiates with ``torch.func.grad_and_value``.

What a backward must do depends on what the axis carries:

- a **model axis** (the experts' ``ep_axis``, tensor parallelism's
  ``"model"``) splits one replicated computation among its peers: every
  peer's loss is the same value, so the cotangent a peer holds of a
  replicated tensor is the whole one. A replicated input that each peer
  uses on its own part of the work (``replicated``, Megatron's f: the
  input of a column split, the experts' tokens) sums the peers' partial
  gradients; a sum of the peers' partial outputs that every peer then
  uses whole (``reduce_from_peers``, Megatron's g: after a row split)
  passes its cotangent on as it is; a gathered output (``all_gather``)
  gives each peer back its own block of the cotangent, not a sum, which
  would count every token once a peer. JAX's ``shard_map`` transpose
  reaches the same gradients by dividing a replicated output's cotangent by
  the axis size and summing (``psum_scatter``) in the backward. A sum
  whose result each peer uses on its own part only (the Mamba2 gated
  norm's sum of squares) is a ``psum``: its cotangent is partial too;
- **data axes** carry different examples: each rank's loss is its term of
  a mean that the train step completes (``ordered_pmean`` of the
  gradients), so ``psum``'s backward is the ordered sum of the cotangents,
  JAX's transpose of ``psum``.

``all_to_all`` (equal splits, device-major, ``split_axis = concat_axis =
0``, ``jax.lax.all_to_all(..., tiled=False)``) is its own transpose.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core.distributed import (gather_parts, host_copy,
                                          host_empty, ordered_psum_op)
from repro_torch.launch.mesh import group_handle, group_of

# What this process's transfers did, summed: "calls" that crossed ranks
# and "sent_bytes" by kind (the operand's bytes, the cost counter's
# measure). Telemetry for the ranks' reports (``chip_smoke.py
# --mesh-rank``); the model never reads it.
COLLECTIVE_COUNTS = {"all-to-all": {"calls": 0, "sent_bytes": 0},
                     "all-gather": {"calls": 0, "sent_bytes": 0}}


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


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(x, n, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # through the Function: under torch.func.grad a backward runs
        # differentiably, and the bare custom op has no usable autograd
        return _PSum.apply(g, ctx.n, ctx.group), None, None

    @staticmethod
    def vmap(info, in_dims, x, n, group):
        return _Replicated.apply(x, n, group), in_dims[0]


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


def replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is, held alike by every peer of ``axis``, which each use
    it on their own part of the work: the backward sums the peers' partial
    cotangents in rank order."""
    n, group = _axis(mesh, axis)
    return x if n == 1 else _Replicated.apply(x, n, group)


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
