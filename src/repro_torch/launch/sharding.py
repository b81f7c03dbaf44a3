"""Sharding rules: parameter, batch and cache specs per architecture, and
the blocks a rank of a mesh holds.

Port of ``repro.launch.sharding``. A spec is a plain tuple, the port's
``PartitionSpec``: one entry per dimension (an axis name, a tuple of axis
names, or ``None`` for a dimension held whole), or ``()`` for a leaf held
whole on every rank. The rules are the reference's, with every
divisibility fallback:

- tensor parallelism over the ``model`` axis: vocab, attention heads (only
  where whole heads land on a shard), FFN hidden, the MoE expert axis,
  Mamba2 inner channels;
- batch over (``pod``, ``data``);
- the small families (``REPLICATED_ARCHS``) replicate their parameters and
  use the whole mesh for batch;
- decode caches: batch over ``data``; kv-heads over ``model`` where they
  divide, else head_dim; a batch that does not divide shards the sequence;
- ``fsdp=True`` also shards the largest still-whole dimension over the data
  axes.

``shard_of`` cuts a rank's block out of a whole leaf, ``unshard`` gathers
the blocks back in rank order (the counterparts of ``to_named``, which
hands a spec to XLA). ``rank_specs`` is what the port executes:
``param_specs`` whole (no ``fsdp``), every ``model`` rule with its
fallback. The layers read which split they hold from their leaves' shapes
against the config (``models/attention.py``, ``layers.apply_mlp``,
``models/mamba2.py``, ``models/api.py``'s vocabulary, ``models/moe.py``'s
experts), so a leaf held whole runs whole, with no collective.

The decode cache a rank holds (``Model.init_cache`` on a mesh) is the one
its own compute needs, which is ``cache_specs``' block where that spec
splits the kv heads or the SSM heads over ``model``. Where the kv heads do
not divide, ``cache_specs`` splits ``head_dim`` (or, for a batch that
does not divide, the sequence) instead; the port's rank holds the kv heads
its query heads read, whole, since its attention runs on whole heads.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import InputShape, ModelConfig

REPLICATED_ARCHS = ("xlstm", "audio")   # families too small for 16-way TP

Spec = tuple


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape[n]
        return out
    return mesh.shape[name]


def _dp(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _shard_dim(shape, dim: int, axis, mesh,
               base: Optional[list] = None) -> Spec:
    """``axis`` on ``dim`` if it divides, else that dimension whole."""
    spec = base[:] if base else [None] * len(shape)
    if shape[dim] % _axis_size(mesh, axis) == 0:
        spec[dim] = axis
    return tuple(spec)


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts and lists, keeping the nesting;
    ``path`` holds the dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_name(path) -> str:
    return "/".join(str(p) for p in path)


def param_specs(cfg: ModelConfig, params_shapes: Any, mesh, *,
                fsdp: bool = False, replicate: bool = False) -> Any:
    """A spec per parameter leaf (anything with a ``shape``).

    ``replicate=True`` forces the population-style layout (parameters
    replicated, the whole mesh as data parallelism)."""
    replicated = replicate or cfg.family in REPLICATED_ARCHS
    dp = _dp(mesh)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        nd = len(shape)
        if replicated or nd == 0:
            return ()
        spec = None
        # name-based tensor-parallel rules (last dims; stack axes untouched)
        if name.endswith("embed"):
            spec = _shard_dim(shape, 0, "model", mesh)
        elif name.endswith("head"):
            spec = _shard_dim(shape, nd - 1, "model", mesh)
        elif "/attn/" in name or "self_attn" in name or "cross_attn" in name:
            # projections only where whole heads land on shards
            tp = mesh.shape["model"]
            q_ok = cfg.n_heads % tp == 0
            kv_ok = cfg.n_kv_heads % tp == 0
            if any(name.endswith(s) for s in ("wq", "bq")) and q_ok:
                spec = _shard_dim(shape, nd - 1, "model", mesh)
            elif any(name.endswith(s)
                     for s in ("wk", "wv", "bk", "bv")) and kv_ok:
                spec = _shard_dim(shape, nd - 1, "model", mesh)
            elif name.endswith("wo") and q_ok:
                spec = _shard_dim(shape, nd - 2, "model", mesh)
            else:
                spec = ()
        elif "/moe/" in name:
            if name.endswith("router"):
                spec = ()
            else:   # [.., E, d, f] / [.., E, f, d]: the experts over model
                spec = _shard_dim(shape, nd - 3, "model", mesh)
        elif "/mixer/" in name:  # Mamba2 (head-parallel TP)
            if any(name.endswith(s)
                   for s in ("w_z", "w_x", "w_dt", "conv_x_w")):
                spec = _shard_dim(shape, nd - 1, "model", mesh)
            elif name.endswith("out_proj"):
                spec = _shard_dim(shape, nd - 2, "model", mesh)
            elif any(name.endswith(s) for s in ("A_log", "D", "dt_bias",
                                                "conv_x_b", "norm_scale")):
                spec = _shard_dim(shape, nd - 1, "model", mesh)
        elif "mlp/" in name or "/mlp" in name:
            if name.endswith("wo"):
                spec = _shard_dim(shape, nd - 2, "model", mesh)
            elif "wi_" in name:
                spec = _shard_dim(shape, nd - 1, "model", mesh)
        if spec is None:
            spec = ()
        if fsdp and nd >= 2:
            # also shard the largest still-whole dimension over data
            dims = sorted(range(nd), key=lambda d: -shape[d])
            taken = list(spec) + [None] * (nd - len(spec))
            for d in dims:
                if taken[d] is None and shape[d] % _axis_size(mesh, dp) == 0 \
                        and shape[d] >= 1024:
                    taken[d] = dp
                    break
            spec = tuple(taken)
        return spec

    return tree_map_with_path(rule, params_shapes)


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh, *,
                replicate: bool = False) -> Dict[str, Spec]:
    """Input specs of a train or prefill batch."""
    dp = _dp(mesh)
    small = replicate or cfg.family in REPLICATED_ARCHS
    baxis = (dp if not small else
             (("pod", "data", "model") if "pod" in mesh.axis_names
              else ("data", "model")))
    b = shape.global_batch
    if b % _axis_size(mesh, baxis) != 0:
        baxis = dp if b % _axis_size(mesh, dp) == 0 else None
    specs: Dict[str, Spec] = {"tokens": (baxis, None)}
    if cfg.family == "vlm":
        specs["vision_embed"] = (baxis, None, None)
    if cfg.family == "audio":
        specs["audio_embed"] = (baxis, None, None)
    return specs


def cache_specs(cfg: ModelConfig, cache_shapes: Any, batch: int,
                mesh) -> Any:
    """Specs of a decode cache (a tree like the cache)."""
    dp = _dp(mesh)
    dp_size = _axis_size(mesh, dp)
    small_batch = batch % dp_size != 0

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        nd = len(shape)
        spec = [None] * nd
        # the batch dim: the first equal to ``batch`` (after any stack axis)
        try:
            bdim = next(d for d in range(nd) if shape[d] == batch)
        except StopIteration:
            return ()
        if not small_batch:
            spec[bdim] = dp
        last = name.split("/")[-1]
        if ("k" in last or "v" in last) and nd >= bdim + 4:
            # KV cache [.., B, S, KV, hd]
            sdim, kvdim, hddim = bdim + 1, bdim + 2, bdim + 3
            if shape[kvdim] % mesh.shape["model"] == 0:
                spec[kvdim] = "model"
            elif shape[hddim] % mesh.shape["model"] == 0:
                spec[hddim] = "model"
            if small_batch and shape[sdim] % dp_size == 0:
                spec[sdim] = dp
        elif "ssm" in name and nd >= bdim + 3:
            # [.., B, H, P, N]
            if shape[bdim + 1] % mesh.shape["model"] == 0:
                spec[bdim + 1] = "model"
        return tuple(spec)

    return tree_map_with_path(rule, cache_shapes)


# ---------------------------------------------------------------------------
# a rank's blocks
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def shard_of(leaf: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole ``leaf`` under ``spec``: each
    dimension with axes is cut into as many equal blocks as those axes
    have ranks, and the rank keeps the block at its index along them
    (row-major over a tuple of axes, ``jax.sharding``'s layout). A view
    where it can be."""
    out = leaf
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.axis_size(_axes(entry))
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(leaf.shape)} does "
                             f"not divide into {n} blocks")
        step = out.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(_axes(entry)) * step, step)
    return out


def unshard(block: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``block`` (``shard_of``'s inverse):
    the blocks of each cut dimension gathered in rank order through host
    memory, on ``block``'s device."""
    out = block
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        n = mesh.axis_size(axes)
        if n == 1:
            continue
        host = out.detach().cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=mesh.group(axes))
        out = torch.cat(parts, dim=dim).to(block.device)
    return out


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """``shard_of`` over a tree and its specs (a tree of tuples)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, tuple):
        return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs))
    return shard_of(tree, specs, mesh)


def rank_specs(cfg: ModelConfig, params: Any, mesh,
               moe_ep_axis: Optional[str] = "model", *,
               replicate: bool = False) -> Any:
    """The blocks a rank of ``mesh`` holds: ``param_specs`` (``fsdp=False``)
    executed whole, with every fallback. ``moe_ep_axis=None`` (the
    data-parallel MoE) holds the experts whole; ``replicate=True`` (the
    population layout) holds every leaf whole."""
    if moe_ep_axis not in (None, "model"):
        raise ValueError(f"the experts split over 'model' or nothing, not "
                         f"{moe_ep_axis!r}")
    specs = param_specs(cfg, params, mesh, replicate=replicate)
    if moe_ep_axis is not None:
        return specs

    def whole_experts(tree, path=()):
        # the specs' tree, its leaves tuples: walk the dicts and lists only
        if isinstance(tree, dict):
            return {k: whole_experts(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [whole_experts(v, path + (i,)) for i, v in enumerate(tree)]
        return () if "/moe/" in _leaf_name(path) else tree
    return whole_experts(specs)
