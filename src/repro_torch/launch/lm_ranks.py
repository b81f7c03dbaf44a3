"""The pieces one rank of the LM stack on a ``(data, model)`` mesh of ranks
is made of.

A rank of ``launch.multiprocess.spawn_local_cluster`` (gloo, all ranks on
one card or CPU; ``chip_smoke.py --mesh-rank`` on the card) builds the
mesh (``launch.mesh.make_lm_mesh``) and the model with ``mesh=``
(``rank_model``: its MoE layers take the expert-parallel path, or the
data-parallel one with ``moe_ep_axis=None``), draws the full parameters
from a seed, the same on every rank (``full_params``), keeps its block
(``rank_params``: ``launch.sharding.moe_specs``, its experts), and takes its
block of a batch (``rank_batch``: ``launch.sharding.batch_specs``). The
steps it then runs are the port's own (``steps.make_prefill_step``,
``serve.generate``, ``steps.make_train_step``).

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
from repro_torch.launch.sharding import (batch_specs, moe_specs, shard_of,
                                         shard_tree)
from repro_torch.models import build_model


def rank_model(cfg: ModelConfig, data: int, model_size: int, **kw):
    """(mesh, model): the ``(data, model)`` mesh over the world and
    ``build_model(cfg, mesh=mesh, **kw)``."""
    mesh = make_lm_mesh(data, model_size)
    return mesh, build_model(cfg, mesh=mesh, **kw)


def full_params(model, seed: int, device) -> Dict[str, Any]:
    """The whole model's parameters from ``seed`` (every rank alike)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return model.init(gen)


def rank_params(model, params: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's block of ``params``, copied out of the whole (which the
    caller can then free)."""
    if model.mesh is None:
        return params
    specs = moe_specs(model.cfg, params, model.mesh, model.moe_ep_axis)
    return tree_map(lambda t: t.clone(),
                    shard_tree(params, specs, model.mesh))


def rank_batch(cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of a batch (``batch_specs``: over the data axes
    where the batch divides, whole on every rank where it does not)."""
    b, s = batch["tokens"].shape
    specs = batch_specs(cfg, InputShape("rank", s, b, "train"), mesh)
    return {k: shard_of(v, specs[k], mesh) if k in specs else v
            for k, v in batch.items()}


def tokens(cfg: ModelConfig, b: int, s: int, seed: int, device):
    """A [b, s] batch of token ids from ``seed`` (every rank alike)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=gen,
                         device=resolve_device(device))
