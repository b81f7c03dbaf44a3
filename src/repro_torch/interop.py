"""Carry the JAX reference's state across, as numpy, into the port.

The port keeps parameters in the reference's layouts (conv HWIO, dense
``[in, out]``) under the reference's key paths, written as one flat dict
with dotted keys (``conv1``, ``bn1.scale``, ``fc1_b``, ...). Carrying
weights across is then a dtype/device move, and sorted key order equals
``jax.tree.flatten``'s leaf order, so the flat ``[M, D]`` matrix of the
aggregation has the same column order in both packages.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{dotted path: leaf}`` in sorted-key order."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tensor(x, dev: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: widen exactly
        return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.tensor(a, device=dev)


def params_from_numpy(tree: Dict[str, Any], device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """A JAX parameter pytree (numpy leaves) -> the port's dict of tensors."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in flatten_tree(tree).items()}


def population_from_numpy(state: Dict[str, Any], device="cuda"
                          ) -> Dict[str, Any]:
    """The reference's population state (numpy leaves) -> the port's."""
    dev = resolve_device(device)
    fresh = state["fresh"]
    return {
        "mule_models": params_from_numpy(state["mule_models"], dev),
        "fixed_models": params_from_numpy(state["fixed_models"], dev),
        "mule_ts": _tensor(state["mule_ts"], dev),
        "fresh": {k: _tensor(fresh[k], dev)
                  for k in ("ages", "count", "threshold")},
        "t": _tensor(state["t"], dev),
    }


def to_numpy(tree: Any) -> Any:
    """Tensors (in dicts, tuples or lists) -> numpy arrays, on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy() \
            if tree.dtype == torch.bfloat16 else tree.detach().cpu().numpy()
    return tree
