"""Step builders: training, prefill and decode.

Port of ``repro.launch.steps``. The reference's jit targets are plain
functions here (PyTorch runs eagerly). The train step differentiates
``Model.loss`` with ``torch.func.grad_and_value``; the kernels' ops carry
their own backward (the plain version's, as the reference has no backward
kernel), so on the card the forward runs the hand-written kernels.

On a mesh of ranks (``Model.mesh``) each rank differentiates the loss of
its block of the batch, and the float32 gradients are averaged over the
axes the batch is cut along (``Model.batch_axes``: the data axes, and
``"model"`` where every leaf is held whole) with ``core.distributed.
ordered_pmean``, leaf by leaf in pieces. A leaf split over ``"model"`` is
so averaged over the data axes only, and a leaf held whole on the model
peers has the same gradient on each already (tensor parallelism's
collectives sum the peers' partial gradients in rank order): every rank
then takes the same Adam step, so the weights and the optimizer state
that ranks hold alike stay bitwise equal. The loss and the nll in the
metrics are averaged the same way (the aux loss is already the mesh's).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict

import torch

from repro_torch.interop import tree_leaves, tree_map
from repro_torch.models.api import Model
from repro_torch.optim import Optimizer


# the gradients cross ranks through host memory in pieces of at most this
# many elements (128 MB of float32), so that no rank stages a copy of all
_PMEAN_CHUNK = 1 << 25


def _replace_leaves(tree, fn) -> None:
    """Each leaf of a tree of dicts and lists replaced by ``fn(leaf)`` in
    place, in ``tree_leaves``' order, so an old leaf is freed as soon as
    its new one exists."""
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    for k in keys:
        if isinstance(tree[k], (dict, list)):
            _replace_leaves(tree[k], fn)
        else:
            tree[k] = fn(tree[k])


def _mesh_mean(model: Model, grads, metrics: Dict[str, Any]):
    """The gradients (in place in their tree) and the loss terms averaged
    over the axes of ``model.mesh`` that the batch is cut along
    (``Model.batch_axes``; unchanged without a mesh)."""
    mesh, axes = model.mesh, model.batch_axes
    if mesh is None or mesh.axis_size(axes) == 1:
        return grads, metrics
    from repro_torch.core.distributed import ordered_pmean

    def mean(g):
        flat = g.reshape(-1)
        return torch.cat([ordered_pmean(flat[i: i + _PMEAN_CHUNK], mesh,
                                        axes)
                          for i in range(0, flat.numel(), _PMEAN_CHUNK)]
                         ).view(g.shape)

    names = [k for k in ("loss", "nll") if k in metrics]
    terms = mean(torch.stack([metrics[k].float() for k in names]))
    _replace_leaves(grads, mean)
    return grads, {**metrics, **dict(zip(names, terms))}


# the in-place update takes each leaf in pieces of at most this many
# elements (64 MB of float32), so its temporaries stay small
_UPDATE_CHUNK = 1 << 24


def _donated_update(optimizer: Optimizer, params, grads, opt_state):
    """``optimizer.update`` a piece of a leaf at a time (the port's
    optimizers are elementwise), each piece's new weight and state written
    into the old tensors, and each gradient dropped once used: the same
    bits as the whole-tree update, holding one piece's temporaries beside
    the weights and the state in place of a second copy of both (JAX's
    buffer donation)."""
    p_leaves = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    del grads
    trees = {k: tree_leaves(v) for k, v in opt_state.items() if k != "step"}
    step = new_step = opt_state["step"]
    for i, p in enumerate(p_leaves):
        leaf = [p, g_leaves[i]] + [v[i] for v in trees.values()]
        for pc, gc, *sc in zip(*(_pieces(t, p.is_contiguous())
                                 for t in leaf)):
            new_p, new_s = optimizer.update(
                {"x": pc}, {"x": gc},
                {"step": step, **{k: {"x": c} for k, c in zip(trees, sc)}})
            pc.copy_(new_p["x"])
            for k, c in zip(trees, sc):
                c.copy_(new_s[k]["x"])
            new_step = new_s["step"]
        g_leaves[i] = leaf = None
    return params, {**opt_state, "step": new_step}


def _pieces(t: torch.Tensor, flat: bool) -> list:
    """Views that tile ``t``: flat pieces of _UPDATE_CHUNK elements, or (a
    weight that is a view across its storage) its rows."""
    if flat:
        t = t.reshape(-1)
        return [t[at: at + _UPDATE_CHUNK]
                for at in range(0, t.numel(), _UPDATE_CHUNK)]
    return list(t.unbind(0)) if t.dim() > 1 else [t]


def make_train_step(model: Model, optimizer: Optimizer,
                    microbatches: int = 1, donate: bool = False) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    With ``microbatches > 1`` each leaf of ``batch`` is cut into that many
    equal slices along axis 0, and the float32 gradients are summed slice
    by slice in order (the reference's ``lax.scan``), then divided by the
    count; ``metrics`` is then ``{"loss": mean of the slices' losses}``.
    ``donate=True`` updates ``params`` and ``opt_state`` in place
    (``_donated_update``; the caller's trees are the returned ones).
    """
    grad_fn = torch.func.grad_and_value(model.loss, has_aux=True)
    update = (functools.partial(_donated_update, optimizer) if donate
              else optimizer.update)

    if microbatches <= 1:
        def train_step(params, opt_state, batch):
            grads, (loss, metrics) = grad_fn(params, batch)
            grads, metrics = _mesh_mean(model, grads,
                                        {**metrics, "loss": loss})
            params, opt_state = update(params, grads, opt_state)
            return params, opt_state, metrics

        return train_step

    def train_step(params, opt_state, batch: Dict[str, Any]):
        def split(leaf):
            b = leaf.shape[0]
            if b % microbatches:
                raise ValueError(f"batch of {b} does not split into "
                                 f"{microbatches} microbatches")
            return leaf.reshape((microbatches, b // microbatches)
                                + leaf.shape[1:])

        micro = tree_map(split, batch)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = None
        for i in range(microbatches):
            grads, (loss, _) = grad_fn(params, tree_map(lambda l: l[i],
                                                        micro))
            gsum = tree_map(lambda a, g: a + g, gsum, grads)
            lsum = loss if lsum is None else lsum + loss
        grads = tree_map(lambda g: (g / microbatches).float(), gsum)
        grads, metrics = _mesh_mean(model, grads,
                                    {"loss": lsum / microbatches})
        del gsum
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(model: Model) -> Callable:
    """(params, batch) -> logits [B, S, V]: the full-sequence forward. The
    batch goes to ``forward`` whole (``vision_embed``, ``audio_embed``,
    ``positions`` beside ``tokens``)."""
    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill


def make_serve_step(model: Model) -> Callable:
    """(params, cache, token [B,1], pos) -> (logits [B, V], cache)."""
    @torch.no_grad()
    def serve(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos)

    return serve
