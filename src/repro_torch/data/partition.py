"""Data partitioning: IID, Dirichlet, and the paper's Shards scheme.

All partitioners return index arrays per device/space; the caller gathers the
underlying arrays. Matches the paper's setups:

- ``dirichlet_partition`` — Hsu et al. [13]: per-device class mixture drawn
  from Dir(alpha). (The paper's Fig. 5 uses alpha in {0.001, 0.01, 0.1}; as
  in the paper's text, *smaller* alpha concentrates fewer classes per space.)
- ``shards_partition`` — FedAvg-style shards adapted per Sec 4.3.1: the 20
  super-classes are split 10/10 between Area 0 and Area 1; within an area
  each of the 4 spaces holds exactly one sub-class of each super-class, and
  each device additionally receives the (unassigned) 5th sub-class as
  general knowledge.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def iid_partition(labels: np.ndarray, n_parts: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(p) for p in np.array_split(idx, n_parts)]


def dirichlet_partition(labels: np.ndarray, n_parts: int, alpha: float,
                        seed: int = 0, min_per_part: int = 8) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    parts: List[List[int]] = [[] for _ in range(n_parts)]
    for c in range(n_classes):
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        while True:  # resample until no part is starved to zero by rounding
            props = rng.dirichlet([alpha] * n_parts)
            if props.max() < 1.0 - 1e-12:
                break
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for p, chunk in enumerate(np.split(idx_c, cuts)):
            parts[p].extend(chunk.tolist())
    out = []
    pool = np.arange(len(labels))
    for p in range(n_parts):
        arr = np.array(sorted(parts[p]), dtype=np.int64)
        if len(arr) < min_per_part:  # top up starved parts with random samples
            extra = rng.choice(pool, size=min_per_part - len(arr), replace=False)
            arr = np.sort(np.concatenate([arr, extra]))
        out.append(arr)
    return out


def shards_partition(super_labels: np.ndarray, sub_labels: np.ndarray,
                     n_areas: int = 2, n_spaces_per_area: int = 4,
                     n_sub: int = 5, seed: int = 0) -> Dict:
    """The paper's adapted Shards scheme (Sec 4.3.1).

    Returns dict with:
      space_idx[(area, space)]  -> indices matching that space's distribution
      general_idx[(area, space)] -> indices of the 5th (held-out) sub-class
                                    for the supers of that area
    """
    rng = np.random.default_rng(seed)
    n_super = int(super_labels.max()) + 1
    supers = rng.permutation(n_super)
    area_supers = np.array_split(supers, n_areas)

    space_idx, general_idx = {}, {}
    for a in range(n_areas):
        # assign one sub-class (0..3) of each super to each space; sub 4 is general
        for sp in range(n_spaces_per_area):
            sel = np.zeros(len(super_labels), bool)
            gen = np.zeros(len(super_labels), bool)
            for s in area_supers[a]:
                sub_of = sub_labels - s * n_sub
                in_super = super_labels == s
                sel |= in_super & (sub_of == sp)
                gen |= in_super & (sub_of == n_sub - 1)
            space_idx[(a, sp)] = np.where(sel)[0]
            general_idx[(a, sp)] = np.where(gen)[0]
    return {"space_idx": space_idx, "general_idx": general_idx,
            "area_supers": [s.tolist() for s in area_supers]}


def train_test_split(idx: np.ndarray, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(idx)
    n_test = max(1, int(len(idx) * test_frac))
    return idx[n_test:], idx[:n_test]
