"""Checkpoints of parameter trees: the leaves in one npz, metadata in JSON.

Port of ``repro.checkpoint.checkpoint``, file for file: each leaf is saved
under the reference's name for its path (the path's keys and list indices
joined by ``/``, e.g. ``stages/0/attn/wq``), so a checkpoint written by
either package restores in the other. The metadata carries the ML Mule
lineage (a model's last-update step) beside ``step``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _named_leaves(tree: Any, prefix: str = ""):
    """(name, leaf) in ``jax.tree_util``'s order: dict keys sorted, lists
    and tuples in order; names are the reference's ``_paths`` keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            raise TypeError("save_checkpoint: bf16 leaves have no numpy "
                            "type here; save float32")
        return leaf.numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Writes ``ckpt_<step>.npz`` and its ``.json`` metadata; returns the
    npz path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    np.savez(path, **{name: _numpy(leaf)
                      for name, leaf in _named_leaves(tree)})
    meta = dict(metadata or {})
    meta["step"] = step
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=float)
    return path


def restore_checkpoint(path: str, template: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template`` (shape-checked); every
    leaf takes the template leaf's dtype and device."""
    data = np.load(path)

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        name = prefix[:-1]
        arr = data[name]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch at {name}: {arr.shape} vs "
                             f"{tuple(tree.shape)}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=tree.device, dtype=tree.dtype)

    restored = walk(template)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return restored, meta


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(p for p in os.listdir(directory)
                   if p.startswith("ckpt_") and p.endswith(".npz"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None
