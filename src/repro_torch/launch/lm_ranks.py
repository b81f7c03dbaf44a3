"""The pieces one rank of the LM stack on a ``(data, model)`` mesh of ranks
is made of.

A rank of ``launch.multiprocess.spawn_local_cluster`` (gloo, all ranks on
one card or CPU; ``chip_smoke.py --mesh-rank`` on the card) builds the
mesh (``launch.mesh.make_lm_mesh``) and the model with ``mesh=``
(``rank_model``: tensor parallelism over ``"model"``, its MoE layers on
the expert-parallel path, or the data-parallel one with
``moe_ep_axis=None``; ``"model"`` among ``dp_axes``, the population
layout, holds every leaf whole and cuts the batch over ``(data,
model)``), draws the
full parameters from a seed, the same on every rank (``full_params``),
keeps its block (``rank_params``: ``launch.sharding.rank_specs``, the
reference's ``param_specs`` executed), and takes its block of a batch
(``rank_batch``: ``launch.sharding.batch_specs``, and under context
parallelism its block of the sequence). Both read the layout from the
model (``Model.replicate``, ``Model.batch_axes``, ``Model.seq_axis``), so
the blocks, the batch and the reduction over ranks of ``launch.steps``
agree. Its decode
cache is ``Model.init_cache``'s on the mesh: ``cache_specs``' block of
each KV cache, and the SSM heads and ``conv_x`` channels its own compute
reads. The steps it then runs are the
port's own (``steps.make_prefill_step``, ``serve.generate``,
``steps.make_train_step``).

Plumbing, not a launcher: the reference's launchers have no mesh flags,
and neither do the port's.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.interop import tree_map
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.launch.sharding import (batch_specs, rank_specs, shard_of,
                                         shard_tree)
from repro_torch.models import build_model


def rank_model(cfg: ModelConfig, data: int, model_size: int, *,
               seq_axis=None, fsdp: bool = False, head_axis=None,
               ranks=None, **kw):
    """(mesh, model): the ``(data, model)`` mesh over the world (or over
    its ``ranks``: ``(None, None)`` on a rank outside them, which still
    takes part in making the mesh's groups) and ``build_model(cfg,
    mesh=mesh, **kw)`` (``dp_axes=("data", "model"), moe_ep_axis=None``:
    the population layout, every leaf whole). With ``seq_axis`` (context
    parallelism) ``dp_axes`` defaults to the data axes other than it;
    ``fsdp=True`` holds each leaf's FSDP block (``rank_params``) and
    gathers it before use (``Model.fsdp``); ``head_axis="model"`` runs
    attention whose heads do not divide on the rank's padded block of them
    (``Model.head_axis``)."""
    mesh = make_lm_mesh(data, model_size, ranks=ranks)
    if mesh is None:
        return None, None
    if seq_axis is not None:
        kw.setdefault("dp_axes", tuple(a for a in ("data",)
                                       if a != seq_axis))
    return mesh, build_model(cfg, mesh=mesh, seq_axis=seq_axis, fsdp=fsdp,
                             head_axis=head_axis, **kw)


def full_params(model, seed: int, device) -> Dict[str, Any]:
    """The whole model's parameters from ``seed`` (every rank alike)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return model.init(gen)


def rank_params(model, params: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's block of ``params`` (``rank_specs``, with the FSDP cut
    under ``model.fsdp``), copied out of the whole (which the caller can
    then free)."""
    if model.mesh is None:
        return params
    specs = rank_specs(model.cfg, params, model.mesh, model.moe_ep_axis,
                       replicate=model.replicate, fsdp=model.fsdp)
    return tree_map(lambda t: t.clone(),
                    shard_tree(params, specs, model.mesh))


def rank_batch(model, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """This rank's block of a batch on ``model.mesh`` (``batch_specs``:
    over the data axes, or over ``(data, model)`` for ``REPLICATED_ARCHS``
    and under ``model.replicate``, where the batch divides; whole on every
    rank where it does not). Under ``model.seq_axis`` the rows are cut over
    ``Model.batch_axes`` where they divide, and the rank keeps its block of
    the whole sequence (``_seq_block``: each key's rule)."""
    if model.mesh is None:
        return batch
    if model.seq_axis is not None:
        return _seq_block(model, batch)
    b, s = batch["tokens"].shape
    specs = batch_specs(model.cfg, InputShape("rank", s, b, "train"),
                        model.mesh, replicate=model.replicate)
    return {k: shard_of(v, specs[k], model.mesh) if k in specs else v
            for k, v in batch.items()}


def _seq_block(model, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """Each key's rule: the rows over ``model.batch_axes`` where they
    divide; ``positions`` and the whole embedded sequence (for ``vlm`` the
    ``vision_tokens`` prefix, then the text) cut into ``S / n`` blocks of
    ``seq_axis``, ``vision_embed`` and ``tokens`` each giving the rank its
    part of the block (either may be empty); ``audio_embed`` (the encoder's
    frames, which every rank encodes whole) not cut along the
    sequence."""
    mesh, axes = model.mesh, model.batch_axes
    b, t = batch["tokens"].shape
    prefix = model.cfg.vision_tokens
    s = prefix + t
    n = mesh.axis_size(model.seq_axis)
    if s % n:
        raise ValueError(f"a sequence of {s} does not split over {n} "
                         f"ranks of {model.seq_axis!r}")
    rows = axes if axes and b % mesh.axis_size(axes) == 0 else None
    m = s // n
    lo = mesh.axis_index(model.seq_axis) * m
    # the rank's positions [lo, lo + m) of each key's own sequence
    spans = {"vision_embed": (min(lo, prefix), min(lo + m, prefix)),
             "tokens": (max(lo - prefix, 0), max(lo + m - prefix, 0))}
    out = {}
    for k, v in batch.items():
        sdim = v.dim() - 1 if k == "positions" else 1
        spec = [None] * v.dim()
        spec[sdim - 1] = rows
        if k == "positions":
            spec[sdim] = model.seq_axis
        v = shard_of(v, tuple(spec), mesh)
        if k in spans:
            a, z = spans[k]
            v = v[:, a:z]
        out[k] = v
    return out


def tokens(cfg: ModelConfig, b: int, s: int, seed: int, device):
    """A [b, s] batch of token ids from ``seed`` (every rank alike)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen,
                         device=resolve_device(device))
