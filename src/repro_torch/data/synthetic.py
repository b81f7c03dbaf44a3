"""Procedural datasets standing in for CIFAR-100 and EgoExo4D (numpy).

``make_image_dataset`` reproduces the structure the paper's experiments
depend on: hierarchical 20 super-classes x 5 sub-classes. Each super-class
has a smooth spatial prototype; each sub-class adds a distinct offset
pattern; samples add noise + random shifts. A small CNN can learn
super-class classification, and the sub-class structure supports the
paper's Shards partitioning (sub-classes split across spaces).
``make_imu_dataset`` gives the IMU windows of the HAR task (Fig 8),
``make_lm_dataset`` the per-space token streams of the LM zoo's training.

Bitwise-equal to ``repro.data.synthetic``'s functions of the same names for
the same seed (both draw from ``np.random.default_rng``).
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


def make_imu_dataset(seed: int, n_per_cell: int = 60, window: int = 128,
                     channels: int = 6, n_classes: int = 4, n_locations: int = 8,
                     density: np.ndarray | None = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (windows [N,T,C], labels [N], locations [N]).

    Per-activity multi-sinusoid signatures over a 6-axis 50 Hz window, with
    per-location sensor bias/gain domain shift mirroring EgoExo4D's
    location-conditioned activity distribution. ``density`` (optional
    [n_classes, n_locations] of {0,1} or counts) mirrors the paper's
    Table 2: which activities occur at which locations. Default reproduces
    its sparsity pattern (several zero cells).
    """
    rng = np.random.default_rng(seed)
    if density is None:
        # Paper Table 2 (rows: Bike Repair, Cooking, Dance, Music) presence:
        density = np.array([
            [1, 1, 1, 0, 1, 0, 0, 0],
            [0, 1, 1, 1, 1, 1, 1, 1],
            [0, 0, 0, 0, 0, 0, 1, 1],
            [0, 0, 0, 1, 1, 0, 0, 1],
        ], dtype=np.float64)[:n_classes, :n_locations]
    t = np.arange(window) / 50.0  # 50 Hz
    base_freqs = rng.uniform(0.5, 8.0, size=(n_classes, channels, 3))
    base_amps = rng.uniform(0.3, 1.2, size=(n_classes, channels, 3))
    loc_bias = rng.normal(scale=0.25, size=(n_locations, channels))
    loc_gain = 1.0 + rng.normal(scale=0.12, size=(n_locations, channels))

    xs, ys, locs = [], [], []
    for c in range(n_classes):
        for l in range(n_locations):
            if density[c, l] == 0:
                continue
            n = int(n_per_cell * max(density[c, l], 1))
            phase = rng.uniform(0, 2 * np.pi, size=(n, channels, 3))
            sig = np.zeros((n, window, channels))
            for k in range(3):
                sig += (base_amps[c, :, k][None, None]
                        * np.sin(2 * np.pi * base_freqs[c, :, k][None, None] * t[None, :, None]
                                 + phase[:, None, :, k]))
            sig = sig * loc_gain[l][None, None] + loc_bias[l][None, None]
            sig += rng.normal(scale=0.4, size=sig.shape)
            xs.append(sig)
            ys.append(np.full(n, c))
            locs.append(np.full(n, l))
    x = np.concatenate(xs).astype(np.float32)
    return x, np.concatenate(ys).astype(np.int32), np.concatenate(locs).astype(np.int32)


def make_lm_dataset(seed: int, n_seqs: int, seq_len: int, vocab: int,
                    n_spaces: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Markov-chain token streams with per-space transition statistics:
    (tokens [n_seqs, seq_len] int32, space of each sequence [n_seqs])."""
    rng = np.random.default_rng(seed)
    seqs = np.zeros((n_seqs, seq_len), np.int32)
    spaces = rng.integers(0, n_spaces, size=n_seqs).astype(np.int32)
    # per-space sparse preferred-next tables
    nxt = rng.integers(0, vocab, size=(n_spaces, vocab, 4))
    for i in range(n_seqs):
        s = spaces[i]
        tok = rng.integers(0, vocab)
        for j in range(seq_len):
            seqs[i, j] = tok
            if rng.random() < 0.8:
                tok = nxt[s, tok, rng.integers(0, 4)]
            else:
                tok = rng.integers(0, vocab)
    return seqs, spaces
