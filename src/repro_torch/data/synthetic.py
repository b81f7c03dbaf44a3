"""Procedural image dataset standing in for CIFAR-100 (numpy).

``make_image_dataset`` reproduces the structure the paper's experiments
depend on: hierarchical 20 super-classes x 5 sub-classes. Each super-class
has a smooth spatial prototype; each sub-class adds a distinct offset
pattern; samples add noise + random shifts. A small CNN can learn
super-class classification, and the sub-class structure supports the
paper's Shards partitioning (sub-classes split across spaces).

Bitwise-equal to ``repro.data.synthetic.make_image_dataset`` for the same
seed (both draw from ``np.random.default_rng``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth_noise(rng: np.random.Generator, size: int, scale: int) -> np.ndarray:
    """Low-frequency pattern via upsampled coarse noise."""
    coarse = rng.normal(size=(scale, scale, 3))
    reps = size // scale
    return np.kron(coarse, np.ones((reps, reps, 1)))


def make_image_dataset(seed: int, n_per_sub: int = 200, n_super: int = 20,
                       n_sub: int = 5, size: int = 32, noise: float = 0.35
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (images [N,H,W,3] float32, super_labels [N], sub_labels [N]).

    sub_labels are globally unique: sub_id = super * n_sub + sub.
    ``noise`` controls sample difficulty (higher -> local overfitting regime,
    where collaboration pays off — the paper's operating point).
    """
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth_noise(rng, size, 4) for _ in range(n_super)])
    sub_offsets = np.stack(
        [[_smooth_noise(rng, size, 8) * 0.6 for _ in range(n_sub)]
         for _ in range(n_super)])
    imgs, sup, sub = [], [], []
    for s in range(n_super):
        for c in range(n_sub):
            base = protos[s] + sub_offsets[s][c]
            noise_arr = rng.normal(scale=noise, size=(n_per_sub, size, size, 3))
            shift = rng.integers(-2, 3, size=(n_per_sub, 2))
            batch = base[None] + noise_arr
            for i in range(n_per_sub):  # small random translations
                batch[i] = np.roll(batch[i], tuple(shift[i]), axis=(0, 1))
            imgs.append(batch)
            sup.append(np.full(n_per_sub, s))
            sub.append(np.full(n_per_sub, s * n_sub + c))
    x = np.concatenate(imgs).astype(np.float32)
    x = (x - x.mean()) / (x.std() + 1e-6)
    return x, np.concatenate(sup).astype(np.int32), np.concatenate(sub).astype(np.int32)
