"""Carry the JAX reference's state across, as numpy, into the port.

The port keeps parameters in the reference's layouts (conv HWIO, dense
``[in, out]``) under the reference's key paths. The CNN's are one flat
dict with dotted keys (``conv1``, ``bn1.scale``, ``fc1_b``, ...): carrying
weights across is then a dtype/device move, and sorted key order equals
``jax.tree.flatten``'s leaf order, so the flat ``[M, D]`` matrix of the
aggregation has the same column order in both packages.

The LM stack keeps the reference's nested pytree (dicts, and the list
``params["stages"]``) as it is: ``tree_from_numpy`` carries it across and
``tree_leaves`` walks it in ``jax.tree.flatten``'s order (dict keys
sorted, lists in order). A dotted flat dict would sort ``stages.10``
before ``stages.2``, so LM trees are never flattened that way.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

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


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts and lists (and of ``rest``,
    which share ``tree``'s structure); keeps the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.flatten``'s order: dict keys sorted, lists in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_from_numpy(tree: Any, device="cuda") -> Any:
    """A nested dict/list pytree of numpy leaves -> the same nesting of
    tensors on ``device`` (bf16 leaves stay bf16)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), tree)


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
