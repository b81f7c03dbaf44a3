"""Harness pieces of the mobile-device image experiment (paper Fig 6).

The torch counterpart of ``benchmarks/common.py``'s mobile image path:
Shards data laid out per mule (``image_data_mobile``, bitwise the
reference's index draws), the CNN's train/eval functions
(``cnn_model_fns``) and a minibatch sampler for the engine's callable
``batches`` (``batch_sampler``). ``run_population`` replays the schedule.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from repro_torch.configs.mule_cnn import CNNConfig
from repro_torch.data import make_image_dataset, shards_partition
from repro_torch.device import resolve_device
from repro_torch.models.cnn import accuracy, cnn_forward, init_cnn, xent_loss


def _pad_to(idx_list: List[np.ndarray], rng) -> np.ndarray:
    n = max(len(i) for i in idx_list)
    out = []
    for i in idx_list:
        if len(i) < n:
            i = np.concatenate([i, rng.choice(i, n - len(i))])
        out.append(i)
    return np.stack(out)


def image_data_mobile(seed: int, n_mules: int, n_fixed: int,
                      mule_space: np.ndarray, mule_area: np.ndarray, *,
                      n_per_sub: int = 16, n_super: int = 20, n_sub: int = 5,
                      image_size: int = 32, noise: float = 3.0,
                      train_per_device: int = 32, device="cuda"
                      ) -> Tuple[torch.Tensor, ...]:
    """Shards data on mules per Sec 4.3.1: space's sub-class + 5th sub-class.

    Returns ``(Xtr [M, N, H, W, 3], Ytr [M, N], Xte [S, Nt, H, W, 3],
    Yte [S, Nt])`` on ``device``; ``Xte[s]`` is space ``s``'s test set.
    """
    dev = resolve_device(device)
    x, sup, sub = make_image_dataset(seed, n_per_sub, n_super, n_sub,
                                     image_size, noise)
    # ceil so every place id's area (place // 4) has a partition, min 2
    n_areas = max(-(-n_fixed // 4), 2)
    sh = shards_partition(sup, sub, n_areas=n_areas, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tr_list = []
    for m in range(n_mules):
        key = (int(mule_area[m]), int(mule_space[m]))
        local = sh["space_idx"][key]
        general = sh["general_idx"][key]
        cap = max(train_per_device // 2, 8)
        take = rng.choice(local, min(len(local), cap), replace=False)
        takeg = rng.choice(general, min(len(general), cap), replace=False)
        tr_list.append(np.concatenate([take, takeg]))
    tr = _pad_to(tr_list, rng)
    te_idx = _pad_to([sh["space_idx"][(a, s)] for a in range(n_areas)
                      for s in range(4)], rng)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (x[tr], sup[tr], x[te_idx], sup[te_idx]))


def cnn_model_fns(cfg: CNNConfig, lr: float) -> Tuple[Callable, ...]:
    """``(init_fn(generator), train_fn(params, batch, key),
    eval_fn(params, x, y))`` — one SGD step on the cross-entropy."""
    def init_fn(generator):
        return init_cnn(generator, cfg)

    def train_fn(params, batch, key):
        xb, yb = batch
        g = torch.func.grad(lambda p: xent_loss(cnn_forward(p, xb), yb))(params)
        return {k: p - lr * g[k] for k, p in params.items()}

    def eval_fn(params, xd, yd):
        return accuracy(cnn_forward(params, xd), yd)

    return init_fn, train_fn, eval_fn


def batch_sampler(X: torch.Tensor, Y: torch.Tensor, batch: int) -> Callable:
    """Mobile-mode ``(seed, t) -> {"fixed": None, "mule": (xb [M, B, ...],
    yb [M, B])}``: uniform minibatches of each mule's data, drawn on
    ``X``'s device from a generator seeded with ``seed``."""
    rows = torch.arange(X.shape[0], device=X.device)[:, None]

    def batch_fn(seed, t):
        g = torch.Generator(device=X.device)
        g.manual_seed(seed)
        idx = torch.randint(0, X.shape[1], (X.shape[0], batch), generator=g,
                            device=X.device)
        return {"fixed": None, "mule": (X[rows, idx], Y[rows, idx])}

    return batch_fn
